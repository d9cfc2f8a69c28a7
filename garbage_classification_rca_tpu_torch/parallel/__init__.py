"""Parallelism on ``torch.distributed``: the data, model, seq and pipe axes
of the JAX package's ``parallel/`` (``mesh.py``, ``multihost.py``,
``fsdp.py``, ``tp.py``, ``sp.py``, ``pp.py``).

One process per GPU (``torchrun``, the JAX package's ``GC_RCA_MULTIHOST``
variables, or ``multihost.launch``); ``--mesh_shape`` lays its named axes
over the ranks in JAX's device order. Each rank holds a contiguous
ascending block of every global batch along the data axis; the model axis
slices the OPT tower Megatron-style (``tp.py``), the seq axis the tokens
of the DistilBERT encoder (``sp.py``), the pipe axis the OPT decoder's
layers into GPipe stages (``pp.py``). The expert axis is not ported yet
(ROADMAP.md, queue 1 item 7).
"""
