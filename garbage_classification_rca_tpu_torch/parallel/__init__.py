"""Data parallelism on ``torch.distributed``: the data axis of the JAX
package's ``parallel/`` (``mesh.py``, ``multihost.py``, ``fsdp.py``).

One process per GPU (``torchrun``, the JAX package's ``GC_RCA_MULTIHOST``
variables, or ``multihost.launch``); the data axis is the world size; each
rank holds a contiguous ascending block of every global batch. The model,
pipe, seq and expert axes are not ported yet (ROADMAP.md, queue 1 item 7).
"""
