"""PyTorch port, tensor parallelism of the OPT tower (``parallel/tp.py``,
the model axis of ``parallel/mesh.py`` and ``models/vlm/opt.py``'s
TP-aware layer), over gloo ranks on the CPU.

  * ``shard_opt_`` leaves, rank by rank, equal the JAX package's
    ``opt_param_specs`` shards of the same tree (fp32 and int8);
  * the OPT decoder's logits (2 layers, hidden 64, 4 heads, FFN 128,
    vocab 97) at ``model:2`` over two ranks equal one process's and the
    JAX ``model:2`` run's within rtol / atol 2e-4 (JAX ``tests/test_tp.py``), the KV caches
    hold the local heads, and the greedy KV-cache streams (fp32, and int8
    weights with the int8 cache) are equal on both ranks, to one process
    and to JAX;
  * one LoRA step of the tiny BLIP-2 (``cli.blip2_train``'s
    ``make_lora_train_step``, fp32, acc 2, the HF dropout sites on) at
    ``model:2`` and at ``data:2,model:2`` (four ranks) equals the
    one-process step: the loss within 1e-5, every adapter gradient within
    1e-4 of its tensor's largest |g|, the updated adapters equal on every
    rank.

One ``multihost.launch`` serves the two-rank cases, another the
four-rank one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.models.vlm import opt as jopt
from garbage_classification_rca_tpu.ops import quant as jquant
from garbage_classification_rca_tpu.parallel import mesh as jmesh
from garbage_classification_rca_tpu.parallel.tp import (opt_param_specs,
                                                        shard_with_specs)
from garbage_classification_rca_tpu_torch.checkpoint.from_jax import (
    load_jax_tree)
from garbage_classification_rca_tpu_torch.models.vlm import opt as topt
from garbage_classification_rca_tpu_torch.ops import quant as tquant
from garbage_classification_rca_tpu_torch.parallel.mesh import DataMesh
from garbage_classification_rca_tpu_torch.parallel.tp import shard_opt_
from tests.test_torch_multihost import VOCAB, launch_script

torch.set_num_threads(2)

JCFG = jopt.OPTConfig(layers=2, hidden=64, heads=4, ffn=128, vocab=97,
                      max_pos=64)
TCFG = topt.OPTConfig(layers=2, hidden=64, heads=4, ffn=128, vocab=97,
                      max_pos=64)
B, L, NEW = 4, 10, 4
TOL = 2e-4                                  # the JAX tests/test_tp.py bar
LOSS_BAR, GRAD_BAR = 1e-5, 1e-4             # PERF.md §2, fp32 train


def opt_params(int8=False):
    params = jopt.init(jax.random.PRNGKey(0), JCFG)
    if int8:
        params = jquant.quantize_opt_weights(params)
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(0)
    params["final_ln"]["bias"] = rng.normal(
        0, 0.1, params["final_ln"]["bias"].shape).astype(np.float32)
    return params


def port_decoder(params):
    model = topt.OPTDecoder(TCFG).requires_grad_(False)
    if params["layers"][0]["q"]["w"].dtype == np.int8:
        tquant.quantize_opt_weights(model)
    load_jax_tree(model, params)
    return model


def inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 97, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[0, -3:] = 0
    mask[2, :2] = 0
    emb = np.asarray(opt_params()["embed_tokens"]["w"])[ids]
    return emb, mask


def lora_window():
    """A window of 2 microbatches of 4 rows for the tiny BLIP-2: images,
    left-padded prompts, label tokens with pads, a padded tail row."""
    rng = np.random.default_rng(7)
    w, b = 2, 4
    mask = np.ones((w, b, 100), np.int32)
    mask[:, :, :60] = 0
    mask[0, 1, 60:70] = 0
    lab = rng.integers(3, 2000, (w, b, 4)).astype(np.int32)
    lab[:, 2, 2:] = 1                                   # PAD_ID
    return {"image": rng.integers(0, 256, (w, b, 224, 224, 3),
                                  dtype=np.uint8),
            "input_ids": rng.integers(3, 2000, (w, b, 100)).astype(np.int32),
            "attention_mask": mask, "label_tokens": lab,
            "label": rng.integers(0, 4, (w, b)).astype(np.int32),
            "valid": np.array([[1, 1, 1, 1], [1, 1, 1, 0]], np.int32)}


# ---------------------------------------------------------------------------
# the rank's work (run in the ranks and, for the reference, in this process)
# ---------------------------------------------------------------------------

WORKER = """
    import os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from garbage_classification_rca_tpu_torch.parallel.multihost import (
        initialize_from_env, make_mesh)
    from tests.test_torch_tp import decoder_work, lora_step

    spec = torch.load(sys.argv[1], weights_only=False)
    mesh = make_mesh(initialize_from_env("cpu"), spec["axes"])
    out = {}
    if spec["decoder"]:
        out.update(decoder_work(mesh, spec["decoder"]))
    out["lora"] = lora_step(mesh, spec["bpe"])
    torch.save(out, f"rank{mesh.rank}.pt")
"""


def decoder_work(mesh, data):
    """The decoder at fp32 and int8 on `mesh` (one process: a mesh of one
    rank), `data` = (emb, mask, {"fp32": tree, "int8": tree}): the final
    hidden states, the caches' width, the greedy streams."""
    emb, mask = (torch.from_numpy(a) for a in data[:2])
    out = {}
    with torch.no_grad():
        for name, params in data[2].items():
            int8 = name == "int8"
            model = shard_opt_(port_decoder(params), mesh)
            if not int8:
                out["logits"] = topt.lm_head(model, topt.decode_hidden(
                    model, emb, mask)).numpy()
                _, caches = topt.prefill(model, emb, mask, NEW)
                out["cache_shape"] = tuple(caches["k"].shape)
            toks, valid = topt.generate(
                model, emb, mask, NEW, eos_id=-1,
                cache_dtype="int8" if int8 else None)
            out[f"tokens_{name}"] = toks.numpy()
    return out


def lora_step(mesh, bpe):
    """One ``make_lora_train_step`` step of the tiny BLIP-2 (fp32, acc 2,
    HF dropout on) on this rank's rows of ``lora_window()``: the loss,
    the adapters' gradients and the updated adapters."""
    from garbage_classification_rca_tpu_torch.cli import blip2_train
    from garbage_classification_rca_tpu_torch.cli.blip2_common import (
        build_blip2, place_blip2)
    from garbage_classification_rca_tpu_torch.config import args_parser
    from garbage_classification_rca_tpu_torch.models.vlm import blip2
    from garbage_classification_rca_tpu_torch.nn.core import Key

    os.environ["GC_RCA_TINY_BLIP2"] = "1"
    args = args_parser(["--seed=3", f"--vocab_dir={bpe}"])
    _, model, _ = build_blip2(args, mesh.device, torch.float32, train=True)
    blip2.init_lora_(model.lora, 5, b_std=0.05)
    place_blip2(model, mesh)
    _, step = blip2_train.make_lora_train_step(
        model, acc_steps=2, compute_dtype=torch.float32,
        hf_internal_dropout=True, mesh=mesh)
    window = lora_window()
    rows = mesh.local_rows(window["label"].shape[1])
    loss = step({k: torch.from_numpy(v[:, rows]) for k, v in window.items()},
                Key(11))
    return {"loss": float(loss),
            "grads": {n: p.grad.clone()
                      for n, p in model.lora.named_parameters()},
            "state": {k: v.clone() for k, v in model.lora.state_dict().items()}}


def decoder_data():
    return inputs() + ({"fp32": opt_params(), "int8": opt_params(True)},)


@pytest.fixture(scope="module")
def one_process():
    return decoder_work(DataMesh(0, 1), decoder_data()), \
        lora_step(DataMesh(0, 1), os.path.join(VOCAB, "bpe"))


def _axes(spec):
    """"data:2,model:2" -> {"data": 2, "model": 2}."""
    return {n: int(k) for n, k in (p.split(":") for p in spec.split(","))}


def _launch(tmp_path_factory, axes, nproc, decoder):
    d = tmp_path_factory.mktemp("tp")
    spec = d / "spec.pt"
    torch.save({"axes": axes, "decoder": decoder_data() if decoder else None,
                "bpe": os.path.join(VOCAB, "bpe")}, spec)
    launch_script(d, WORKER, [spec], nproc=nproc)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(nproc)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The one two-rank launch at ``model:2``."""
    return _launch(tmp_path_factory, {"model": 2}, 2, True)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The one four-rank launch at ``data:2,model:2`` (the LoRA step)."""
    return _launch(tmp_path_factory, {"data": 2, "model": 2}, 4, False)


# ---------------------------------------------------------------------------
# the slices
# ---------------------------------------------------------------------------


def _shard_of(a, spec, rank, m):
    """The block of JAX leaf `a` that JAX's `spec` gives model rank
    `rank` of `m`."""
    idx = []
    for d in range(a.ndim):
        if d < len(spec) and spec[d] == "model":
            n = a.shape[d] // m
            idx.append(slice(rank * n, (rank + 1) * n))
        else:
            idx.append(slice(None))
    return a[tuple(idx)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("rank", [0, 1])
def test_shard_opt_slices_match_jax_specs(rank, int8):
    """Every leaf of the sliced decoder, in the JAX layout, is the JAX
    ``opt_param_specs`` shard of the same tree for model rank `rank`."""
    params = opt_params(int8)
    specs = opt_param_specs(params)
    mesh = DataMesh(rank, 2, axes=(("model", 2),))
    model = shard_opt_(port_decoder(params), mesh)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    spec_of = dict(jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    n_sharded = 0
    for path, a in leaves:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        owner = model.get_submodule(".".join(str(k) for k in keys[:-1]))
        t = getattr(owner, keys[-1]).detach().numpy()
        if keys[-1] == "w" and t.ndim == 2 and keys[0] == "layers":
            t = t.T                                   # [out, in] -> [in, out]
        want = _shard_of(np.asarray(a), spec_of[path], rank, 2)
        n_sharded += want.shape != np.asarray(a).shape
        assert t.dtype == want.dtype and t.shape == want.shape, keys
        np.testing.assert_array_equal(t, want, err_msg=str(keys))
    # q / k / v / fc1: w and b (and w_scale) a layer, out / fc2: w
    assert n_sharded == JCFG.layers * (4 * (3 if int8 else 2) + 2)
    assert all(lp.tp.size == 2 and lp.tp.rank == rank for lp in model.layers)


def test_shard_opt_refuses_what_does_not_divide():
    with pytest.raises(ValueError, match="must divide"):
        shard_opt_(port_decoder(opt_params()),
                   DataMesh(0, 3, axes=(("model", 3),)))
    model = shard_opt_(port_decoder(opt_params()),
                       DataMesh(0, 2, axes=(("model", 2),)))
    with pytest.raises(ValueError, match="sharded already"):
        shard_opt_(model, DataMesh(0, 2, axes=(("model", 2),)))


# ---------------------------------------------------------------------------
# the decoder over two ranks
# ---------------------------------------------------------------------------


def _jax_tp(fn, params):
    mesh = jmesh.make_mesh("data:1,model:2", jax.devices()[:2])
    return fn(shard_with_specs(mesh, params, opt_param_specs(params)))


def test_tp_decoder_matches_one_process_and_jax(two_ranks, one_process):
    emb, mask = inputs()
    want_j = np.asarray(_jax_tp(jax.jit(lambda p: jopt.decode(
        p, jnp.asarray(emb), jnp.asarray(mask), JCFG)), opt_params()))
    one = one_process[0]["logits"]
    for r in two_ranks:
        np.testing.assert_allclose(r["logits"], one, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["logits"], want_j, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(two_ranks[0]["logits"],
                                  two_ranks[1]["logits"])


def test_tp_caches_hold_the_local_heads(two_ranks, one_process):
    assert one_process[0]["cache_shape"] == (2, B, L + NEW, 64)
    for r in two_ranks:
        assert r["cache_shape"] == (2, B, L + NEW, 32)


@pytest.mark.parametrize("variant", ["fp32", "int8"])
def test_tp_greedy_streams_equal(two_ranks, one_process, variant):
    """The KV-cache greedy streams: the same on both ranks, and equal to
    one process and to the JAX ``generate`` at ``model:2``."""
    emb, mask = inputs()
    cache = "int8" if variant == "int8" else None
    want_j = np.asarray(_jax_tp(jax.jit(lambda p: jopt.generate(
        p, jnp.asarray(emb), jnp.asarray(mask), JCFG, NEW, eos_id=-1,
        cache_dtype=cache)[0]), opt_params(variant == "int8")))
    got = [r[f"tokens_{variant}"] for r in two_ranks]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], one_process[0][f"tokens_{variant}"])
    np.testing.assert_array_equal(got[0], want_j)


# ---------------------------------------------------------------------------
# the LoRA step
# ---------------------------------------------------------------------------


def _grad_errors(got, want):
    return {n: float((got[n] - w).abs().max()) / float(w.abs().max())
            for n, w in want.items()}


@pytest.mark.parametrize("mesh", ["model:2", "data:2,model:2"])
def test_tp_lora_step_matches_one_process(request, one_process, mesh):
    ranks = request.getfixturevalue(
        "two_ranks" if mesh == "model:2" else "four_ranks")
    want = one_process[1]
    for r in ranks:
        got = r["lora"]
        assert abs(got["loss"] - want["loss"]) <= LOSS_BAR * max(
            1.0, abs(want["loss"]))
        errs = _grad_errors(got["grads"], want["grads"])
        assert max(errs.values()) <= GRAD_BAR, errs
        for k, v in got["state"].items():
            assert torch.equal(v, ranks[0]["lora"]["state"][k]), k
    assert all(float(g.abs().max()) > 0 for g in want["grads"].values())
