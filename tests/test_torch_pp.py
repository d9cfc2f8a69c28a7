"""PyTorch port, pipeline parallelism of the OPT decoder (``parallel/pp.py``,
the pipe axis of ``parallel/mesh.py``, ``multihost.ring_step``) over gloo
ranks on the CPU, held to one process and to the JAX package's
``parallel/pp.py`` on the conftest's virtual devices (jitted, as its CLIs
run it). Tiny OPT: 4 layers, hidden 64, 4 heads, FFN 128; a stage is
filled from the JAX ``stack_pipeline_params`` / ``stack_pipeline_lora``
trees (``checkpoint/from_jax.load_pipeline_stage``).

  * stage ownership and its refusals (the JAX messages);
  * ``pp_decode_hidden`` at ``pipe:2``, ``pipe:4`` and ``data:2,pipe:2``,
    M in {1, 2, 4}, and ``pp_decode`` with adapters: the JAX bars (2e-5,
    logits 3e-5; JAX ``tests/test_pp.py``); a batch that does not split
    is refused on every rank;
  * ``pp_lm_loss`` (the decoder's adapters' gradients) and the trainer's
    LoRA step on a tiny BLIP-2 (``cli/blip2_train.make_pp_lora_train_step``,
    fp32, its AdamW) over a window of two microbatches, with and without
    remat: the loss within rtol 2e-5, the updated adapters within rtol
    1e-3 / atol 5e-5 of the one-process ``make_lora_train_step`` and of
    the JAX ``make_pp_lora_train_step`` (the bars of JAX
    ``tests/test_pp_train.py``); a trailing partial window (one
    microbatch, divided by acc 2 all the same) against one process;
  * ``pp_generate``: greedy streams with adapters, with the int8 cache,
    and with an EOS that occurs mid-stream, array-equal to one process's
    ``opt.generate`` and to the JAX ``pp_generate``, the same on every
    rank.

One ``multihost.launch`` runs the two-rank mesh, one the two four-rank
meshes.
"""

import functools
import types

import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu_torch.checkpoint.from_jax import (
    load_blip2_tree, load_jax_tree, load_pipeline_stage)
from garbage_classification_rca_tpu_torch.models.vlm import blip2 as tblip2
from garbage_classification_rca_tpu_torch.models.vlm import blip2_vision
from garbage_classification_rca_tpu_torch.models.vlm import opt as topt
from garbage_classification_rca_tpu_torch.models.vlm import qformer
from garbage_classification_rca_tpu_torch.parallel import pp
from garbage_classification_rca_tpu_torch.parallel.mesh import DataMesh

torch.set_num_threads(2)

TCFG = topt.OPTConfig(layers=4, hidden=64, heads=4, ffn=128, vocab=200,
                      max_pos=64)
B, L, NEW, SCALE = 8, 7, 5, 0.5
ACC = 2                     # the LoRA step's window: two microbatches
MESHES = {"pipe:2": {"pipe": 2}, "pipe:4": {"pipe": 4},
          "data:2,pipe:2": {"data": 2, "pipe": 2}}
MICRO = (1, 2, 4)
TOL, LOGIT_TOL = 2e-5, 3e-5                 # JAX tests/test_pp.py
LOSS_RTOL, ADAPTER_RTOL, ADAPTER_ATOL = 2e-5, 1e-3, 5e-5   # test_pp_train
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


@functools.lru_cache(maxsize=1)
def J():
    """The JAX package's side, imported in the test process only (the
    ranks read every tree from their spec)."""
    import jax
    import optax

    from garbage_classification_rca_tpu.models.vlm import blip2
    from garbage_classification_rca_tpu.models.vlm import blip2_vision as vis
    from garbage_classification_rca_tpu.models.vlm import opt
    from garbage_classification_rca_tpu.models.vlm import qformer as qf
    from garbage_classification_rca_tpu.parallel import pp as jpp
    from garbage_classification_rca_tpu.parallel.mesh import make_mesh

    cfg = opt.OPTConfig(layers=4, hidden=64, heads=4, ffn=128, vocab=200,
                        max_pos=64)
    blip_cfg = blip2.Blip2Config(
        vision=vis.VisionConfig(layers=1, hidden=32, heads=2, ffn=64,
                                patch=14, image_size=28),
        qformer=qf.QFormerConfig(layers=1, hidden=32, heads=2, ffn=64,
                                 n_query=4, cross_frequency=1,
                                 vision_hidden=32),
        opt=opt.OPTConfig(layers=4, hidden=64, heads=4, ffn=128, vocab=300,
                          max_pos=64),
        lora_r=2, lora_alpha=8)
    return types.SimpleNamespace(jax=jax, optax=optax, blip2=blip2, opt=opt,
                                 pp=jpp, make_mesh=make_mesh, cfg=cfg,
                                 blip_cfg=blip_cfg)


def _np(tree):
    return J().jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=1)
def opt_params():
    j = J()
    return _np(j.jax.jit(lambda k: j.opt.init(k, j.cfg))(
        j.jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=1)
def lora_tree():
    rng = np.random.default_rng(3)
    return {str(i): {name: {
        "a": (rng.normal(size=(64, 2)) / np.sqrt(2)).astype(np.float32),
        "b": (rng.normal(size=(2, 64)) * 0.1).astype(np.float32)}
        for name in ("q", "k")} for i in range(TCFG.layers)}


def inputs():
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(B, L, TCFG.hidden)).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    mask[0, -3:] = 0                         # right-padded
    mask[2, -1:] = 0
    mask[5, :2] = 0                          # left-padded
    labels = rng.integers(0, TCFG.vocab, (B, L)).astype(np.int64)
    labels[mask == 0] = -100
    labels[:, :2] = -100
    return emb, mask, labels


def blip_cfg():
    """The port's twin of JAX tests/test_pp_train.py's tiny BLIP-2."""
    return tblip2.Blip2Config(
        vision=blip2_vision.VisionConfig(layers=1, hidden=32, heads=2,
                                         ffn=64, patch=14, image_size=28),
        qformer=qformer.QFormerConfig(layers=1, hidden=32, heads=2, ffn=64,
                                      n_query=4, cross_frequency=1,
                                      vision_hidden=32),
        opt=topt.OPTConfig(layers=4, hidden=64, heads=4, ffn=128, vocab=300,
                           max_pos=64),
        lora_r=2, lora_alpha=8)


@functools.lru_cache(maxsize=1)
def blip_trees():
    j = J()
    jit, key = j.jax.jit, j.jax.random.PRNGKey
    params = jit(lambda k: j.blip2.init(k, j.blip_cfg))(key(0))
    lora = jit(lambda k: j.blip2.init_lora(k, j.blip_cfg))(key(1))
    # B != 0, so that the adapters reach the loss
    lora = j.jax.tree_util.tree_map(
        lambda x: x + 0.01 if x.shape[0] == j.blip_cfg.lora_r else x, lora)
    # the trainer's window: ACC microbatches of B rows (BATCH_KEYS), a
    # left-padded prompt, pad label tokens, a padded tail row
    rng = np.random.default_rng(5)
    n, k = 4, 3
    mask = np.ones((ACC, B, n), np.int32)
    mask[:, 1, :2] = 0
    label_tokens = rng.integers(3, 300, (ACC, B, k)).astype(np.int32)
    label_tokens[:, 3, 1:] = 1                       # PAD_ID
    valid = np.ones((ACC, B), np.int32)
    valid[-1, -1] = 0
    window = {"image": rng.integers(0, 256, (ACC, B, 28, 28, 3)).astype(
                  np.uint8),
              "input_ids": rng.integers(3, 300, (ACC, B, n)).astype(
                  np.int32),
              "attention_mask": mask, "label_tokens": label_tokens,
              "label": rng.integers(0, 4, (ACC, B)).astype(np.int32),
              "valid": valid}
    return _np(params), _np(lora), window


# ---------------------------------------------------------------------------
# a rank's work
# ---------------------------------------------------------------------------

WORKER = """
    import sys
    import torch
    torch.set_num_threads(1)
    from garbage_classification_rca_tpu_torch.parallel.multihost import (
        initialize_from_env, make_mesh)
    from tests.test_torch_pp import stage_work

    spec = torch.load(sys.argv[1], weights_only=False)
    base = initialize_from_env("cpu")
    out = {name: stage_work(make_mesh(base, axes), spec[name])
           for name, axes in spec["meshes"].items()}
    torch.save(out, f"rank{base.rank}.pt")
"""


def build_stage(mesh, stacked, stacked_lora, params):
    s = mesh.coord("pipe")
    dec = pp.stage_layers_(topt.OPTDecoder(TCFG).requires_grad_(False),
                           mesh.size("pipe"), s)
    lora = pp.stage_lora_(topt.Lora(TCFG, 2), TCFG.layers, mesh.size("pipe"),
                          s)
    load_pipeline_stage(dec, stacked, s, lora, stacked_lora)
    for k in ("embed_tokens", "embed_positions", "final_ln"):
        load_jax_tree(getattr(dec, k), params[k], allow_skipped=())
    return dec, lora.requires_grad_(False)


def _errors(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def stage_work(mesh, spec):
    """This rank's share of every check on `mesh`; the last stage's
    outputs, every rank's tokens, losses and adapters."""
    emb, mask, labels = (torch.from_numpy(a) for a in inputs())
    rows = torch.from_numpy(mesh.local_rows(B))
    s = mesh.coord("pipe")
    e = emb[rows] if s == 0 else None
    m, lab = mask[rows], labels[rows]
    dec, lora = build_stage(mesh, spec["stacked"], spec["stacked_lora"],
                            spec["params"])
    out = {"layers": sorted(int(k) for k in dec.layers.keys())}
    with torch.no_grad():
        for n in MICRO:
            out[f"hidden{n}"] = pp.pp_decode_hidden(dec, e, m, mesh, n)
        out["logits"] = pp.pp_decode(dec, e, m, mesh, 2, lora=lora,
                                     lora_scale=SCALE)
        out["refused"] = [_errors(lambda: pp.pp_decode_hidden(
            dec, e, m, mesh, n)) for n in (3, 8)]
        for name, kw in (("lora", {"lora": lora, "lora_scale": SCALE}),
                         ("int8", {"lora": lora, "lora_scale": SCALE,
                                   "cache_dtype": "int8"}),
                         ("eos", {"eos_id": spec["eos"]})):
            out[f"gen_{name}"] = pp.pp_generate(dec, e, m, mesh, NEW, **kw)
    lora.requires_grad_(True)
    for remat in (False, True):
        for p in lora.parameters():
            p.grad = None
        loss = pp.pp_lm_loss(dec, e, m, lab, mesh, 2, lora=lora,
                             lora_scale=SCALE, remat=remat)
        loss.backward()
        out[f"lm_loss_{remat}"] = float(loss)
        out[f"lm_grads_{remat}"] = {k: p.grad.clone()
                                    for k, p in lora.named_parameters()}
        out[f"blip2_{remat}"] = blip2_step(mesh, spec["blip2"], remat=remat)
    out["blip2_partial"] = blip2_step(mesh, spec["blip2"], window=1)
    return out


def port_blip2(trees):
    params, lora, _ = trees
    model = tblip2.build_model(blip_cfg(), "cpu")
    return load_blip2_tree(model, params, lora)


def _window(trees, w, rows=slice(None)):
    """The first `w` microbatches of the tiny BLIP-2's window, `rows` of
    each."""
    return {k: torch.from_numpy(v[:w, rows]) for k, v in trees[2].items()}


def blip2_step(mesh, trees, remat=True, window=ACC):
    """One step of the trainer's ``make_pp_lora_train_step`` (2 pipeline
    microbatches, acc ACC) over this rank's rows of the first `window`
    microbatches of the tiny BLIP-2 `trees`: (loss, the stage's updated
    adapters)."""
    from garbage_classification_rca_tpu_torch.cli import blip2_train

    model = port_blip2(trees)
    n, s = mesh.size("pipe"), mesh.coord("pipe")
    pp.stage_layers_(model.opt, n, s)
    pp.stage_lora_(model.lora, 4, n, s)
    _, step = blip2_train.make_pp_lora_train_step(
        model, mesh, 2, acc_steps=ACC, compute_dtype=torch.float32,
        remat=remat)
    loss = float(step(_window(trees, window, mesh.local_rows(B))))
    return loss, {k: v.clone() for k, v in model.lora.state_dict().items()}


def stacked_trees(n_stages):
    """The JAX ``stack_pipeline_params`` / ``stack_pipeline_lora`` trees
    of `n_stages` stages."""
    jpp = J().pp
    return {"stacked": _np(jpp.stack_pipeline_params(opt_params()["layers"],
                                                     n_stages)),
            "stacked_lora": _np(jpp.stack_pipeline_lora(
                lora_tree(), TCFG.layers, n_stages))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{mesh: [rank outputs]}: the two-rank launch and the four-rank one
    (``pipe:4`` and ``data:2,pipe:2`` in one process group)."""
    from tests.test_torch_multihost import launch_script

    eos = one_process()["eos"]
    out = {}
    for group in (("pipe:2",), ("pipe:4", "data:2,pipe:2")):
        d = tmp_path_factory.mktemp("pp")
        spec = {"meshes": {g: MESHES[g] for g in group}}
        for g in group:
            spec[g] = {"eos": eos, "params": opt_params(),
                       "blip2": blip_trees(),
                       **stacked_trees(MESHES[g]["pipe"])}
        torch.save(spec, d / "spec.pt")
        nproc = 2 if group == ("pipe:2",) else 4
        launch_script(d, WORKER, [d / "spec.pt"], nproc=nproc)
        every = [torch.load(d / f"rank{r}.pt", weights_only=False)
                 for r in range(nproc)]
        for g in group:
            out[g] = [r[g] for r in every]
    return out


@functools.lru_cache(maxsize=1)
def one_process():
    """The whole decoder and the whole BLIP-2 in this process."""
    emb, mask, labels = (torch.from_numpy(a) for a in inputs())
    dec = topt.OPTDecoder(TCFG).requires_grad_(False)
    load_jax_tree(dec, opt_params(), allow_skipped=())
    lora = topt.Lora(TCFG, 2)
    load_jax_tree(lora, lora_tree(), allow_skipped=())
    lora.requires_grad_(False)
    out = {}
    with torch.no_grad():
        out["hidden"] = topt.decode_hidden(dec, emb, mask)
        out["logits"] = topt.lm_head(dec, topt.decode_hidden(
            dec, emb, mask, lora=lora, lora_scale=SCALE))
        out["gen_lora"] = topt.generate(dec, emb, mask, NEW, lora=lora,
                                        lora_scale=SCALE)
        out["gen_int8"] = topt.generate(dec, emb, mask, NEW, lora=lora,
                                        lora_scale=SCALE, cache_dtype="int8")
        # an EOS that the plain stream draws at step 1 of row 0
        out["eos"] = int(topt.generate(dec, emb, mask, NEW)[0][0, 1])
        out["gen_eos"] = topt.generate(dec, emb, mask, NEW,
                                       eos_id=out["eos"])
    lora.requires_grad_(True)
    h = topt.decode_hidden(dec, emb, mask, lora=lora, lora_scale=SCALE,
                           train=True)
    loss = topt.shifted_ce(topt.lm_head(dec, h), labels)
    loss.backward()
    out["lm_loss"] = float(loss.detach())
    out["lm_grads"] = {k: p.grad.clone() for k, p in lora.named_parameters()}
    from garbage_classification_rca_tpu_torch.cli import blip2_train

    for name, w in (("blip2", ACC), ("blip2_partial", 1)):
        model = port_blip2(blip_trees())
        _, step = blip2_train.make_lora_train_step(
            model, acc_steps=ACC, compute_dtype=torch.float32)
        loss = float(step(_window(blip_trees(), w)))
        out[name] = (loss, {k: v.clone()
                            for k, v in model.lora.state_dict().items()})
    return out


# ---------------------------------------------------------------------------
# the JAX package's pipeline on the virtual devices
# ---------------------------------------------------------------------------


def _jit(fn, *args):
    jax = J().jax
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args)


def _jax_stages(mesh_name):
    j = J()
    mesh = j.make_mesh(mesh_name)
    trees = stacked_trees(MESHES[mesh_name]["pipe"])
    return (mesh, j.pp.shard_pipeline_params(mesh, trees["stacked"]),
            j.pp.shard_pipeline_params(mesh, trees["stacked_lora"]))


@functools.lru_cache(maxsize=None)
def jax_decode(mesh_name, n_micro, with_lora=False):
    j = J()
    emb, mask, _ = inputs()
    mesh, stacked, slora = _jax_stages(mesh_name)
    params = opt_params()
    if with_lora:
        return np.asarray(_jit(lambda st, sl, e, m: j.pp.pp_decode(
            params, st, e, m, j.cfg, mesh, n_micro, stage_lora=sl,
            lora_scale=SCALE), stacked, slora, emb, mask))
    return np.asarray(_jit(lambda st, e, m: j.pp.pp_decode_hidden(
        params, st, e, m, j.cfg, mesh, n_micro), stacked, emb, mask))


@functools.lru_cache(maxsize=None)
def jax_generate(variant, eos):
    """The JAX ``pp_generate`` at ``pipe:2`` (its streams are those of
    every mesh: JAX tests/test_pp.py)."""
    j = J()
    emb, mask, _ = inputs()
    mesh, stacked, slora = _jax_stages("pipe:2")
    params = opt_params()
    kw = {"eos_id": eos} if variant == "eos" else {
        "lora_scale": SCALE,
        "cache_dtype": "int8" if variant == "int8" else None}
    lo = None if variant == "eos" else slora
    toks, valid = _jit(lambda st, sl, e, m: j.pp.pp_generate(
        params, st, e, m, j.cfg, mesh, NEW, stage_lora=sl, **kw),
        stacked, lo, emb, mask)
    return np.asarray(toks), np.asarray(valid)


@functools.lru_cache(maxsize=1)
def jax_blip2_step():
    """The JAX trainer's ``make_pp_lora_train_step`` (after its
    ``setup_pipeline``) at ``data:2,pipe:2`` over the whole window:
    (loss, the updated adapters per layer)."""
    from garbage_classification_rca_tpu.cli import blip2_train as jtrain
    from garbage_classification_rca_tpu.cli.blip2_common import (
        setup_pipeline)

    j = J()
    params, lora, window = blip_trees()
    mesh = j.make_mesh("data:2,pipe:2")
    params, stages, slora = setup_pipeline(j.blip_cfg, params, lora, mesh)
    opt, step = jtrain.make_pp_lora_train_step(
        j.blip_cfg, params, stages, mesh, 2, acc_steps=ACC,
        compute_dtype=j.jax.numpy.float32)
    new, _, loss = step(slora, opt.init(slora), window, None)
    return float(loss), j.pp.unstack_pipeline_lora(_np(new))


# ---------------------------------------------------------------------------
# stage ownership
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_stages", [2, 4])
def test_stage_holds_the_jax_stage_slice(n_stages):
    """Each stage keeps its contiguous layers under their global index,
    and ``load_pipeline_stage`` puts the JAX stage slice in them."""
    trees = stacked_trees(n_stages)
    whole = topt.OPTDecoder(TCFG)
    load_jax_tree(whole, opt_params(), allow_skipped=())
    per = TCFG.layers // n_stages
    for s in range(n_stages):
        dec, _ = build_stage(
            DataMesh(s, n_stages, axes=(("pipe", n_stages),)),
            trees["stacked"], trees["stacked_lora"], opt_params())
        assert sorted(dec.layers.keys(), key=int) == [
            str(i) for i in range(s * per, (s + 1) * per)]
        for i, lyr in pp.stage_items(dec):
            for (k, a), b in zip(lyr.state_dict().items(),
                                 whole.layers[i].state_dict().values()):
                assert torch.equal(a, b), (s, i, k)


@pytest.mark.parametrize("case", ["layers", "missing", "uniform", "twice",
                                  "walk"])
def test_stage_refusals(case):
    """The JAX messages: layers that do not split, a missing adapter, a
    non-uniform one; a stage cut twice, and the whole-decoder walk over a
    stage."""
    dec = topt.OPTDecoder(TCFG)
    lora = topt.Lora(TCFG, 2)
    if case == "layers":
        with pytest.raises(ValueError, match="4 layers not divisible by 3"):
            pp.stage_layers_(dec, 3, 0)
    elif case == "missing":
        del lora["2"]
        with pytest.raises(ValueError, match="adapter for every layer"):
            pp.stage_lora_(lora, 4, 2, 0)
    elif case == "uniform":
        del lora["2"]["k"]
        with pytest.raises(ValueError, match="uniform adapter structure"):
            pp.stage_lora_(lora, 4, 2, 0)
    elif case == "twice":
        pp.stage_layers_(dec, 2, 1)
        with pytest.raises(ValueError, match="stage already"):
            pp.stage_layers_(dec, 2, 1)
    else:
        pp.stage_layers_(dec, 2, 1)
        emb, mask, _ = inputs()
        with pytest.raises(TypeError, match="parallel/pp.py"):
            topt.decode_hidden(dec, torch.from_numpy(emb),
                               torch.from_numpy(mask))


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


def _last(ranks_, mesh_name, key):
    """The last stage's `key` of every data rank, rows in order."""
    n = MESHES[mesh_name]["pipe"]
    return torch.cat([r[key] for i, r in enumerate(ranks_) if i % n == n - 1])


@pytest.mark.parametrize("n_micro", MICRO)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_pp_decode_hidden_matches_one_process_and_jax(ranks, mesh_name,
                                                      n_micro):
    got = _last(ranks[mesh_name], mesh_name, f"hidden{n_micro}")
    n = MESHES[mesh_name]["pipe"]
    assert all(r[f"hidden{n_micro}"] is None
               for i, r in enumerate(ranks[mesh_name]) if i % n != n - 1)
    np.testing.assert_allclose(got.numpy(), one_process()["hidden"].numpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), jax_decode(mesh_name, n_micro),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_pp_decode_logits_with_adapters(ranks, mesh_name):
    got = _last(ranks[mesh_name], mesh_name, "logits").numpy()
    want = one_process()["logits"].numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(got, jax_decode(mesh_name, 2, True),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_pp_refuses_a_batch_that_does_not_split(ranks, mesh_name):
    """On every rank, with the JAX messages: 8 rows into 3 microbatches;
    microbatches of one row over a data axis of two."""
    for r in ranks[mesh_name]:
        assert r["refused"][0] == "batch 8 not divisible by 3 microbatches"
        assert (r["refused"][1] is None) == (mesh_name != "data:2,pipe:2")
        if mesh_name == "data:2,pipe:2":
            assert r["refused"][1] == ("microbatch size 1 not divisible by "
                                       "data-axis size 2")


# ---------------------------------------------------------------------------
# the backward and the LoRA step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_pp_lm_loss_and_adapter_grads(ranks, mesh_name, remat):
    """Each stage's adapter gradients are the one-process ones (every
    data rank's sum, weighed by its counted tokens) and the loss is the
    same on every stage of a pipe."""
    want = one_process()
    n = MESHES[mesh_name]["pipe"]
    _, _, labels = inputs()
    every = ranks[mesh_name]
    groups = [every[i:i + n] for i in range(0, len(every), n)]
    counts = [int((labels[r][:, 1:] != -100).sum())
              for r in np.split(np.arange(B), len(groups))]
    losses = []
    for group in groups:
        assert len({r[f"lm_loss_{remat}"] for r in group}) == 1
        losses.append(group[0][f"lm_loss_{remat}"])
    np.testing.assert_allclose(np.dot(losses, counts) / sum(counts),
                               want["lm_loss"], rtol=LOSS_RTOL)
    for s in range(n):
        stage = [group[s] for group in groups]
        grads = {k: sum(r[f"lm_grads_{remat}"][k] * c
                        for r, c in zip(stage, counts)) / sum(counts)
                 for k in stage[0][f"lm_grads_{remat}"]}
        assert set(grads) == {f"{i}.{p}.{ab}" for i in stage[0]["layers"]
                              for p in ("q", "k") for ab in ("a", "b")}
        for k, g in grads.items():
            np.testing.assert_allclose(g.numpy(), want["lm_grads"][k].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)


def _held_to(ranks_, key, want_loss, want):
    """Every rank's loss and its stage's updated adapters against one
    process's; the stages together hold every adapter."""
    seen = set()
    for r in ranks_:
        loss, state = r[key]
        np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
        assert state and set(state) <= set(want)
        seen |= set(state)
        for k, v in state.items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=ADAPTER_RTOL, atol=ADAPTER_ATOL,
                                       err_msg=k)
    assert seen == set(want)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_pp_blip2_lora_step_matches_one_process_and_jax(ranks, mesh_name,
                                                        remat):
    """The trainer's GPipe step over a window of ACC microbatches, held
    to the one-process trainer step and to the JAX trainer's pipe step."""
    want_loss, want = one_process()["blip2"]
    _held_to(ranks[mesh_name], f"blip2_{remat}", want_loss, want)
    j_loss, j_lora = jax_blip2_step()
    for r in ranks[mesh_name]:
        loss, state = r[f"blip2_{remat}"]
        np.testing.assert_allclose(loss, j_loss, rtol=LOSS_RTOL)
        for k, v in state.items():
            i, name, ab = k.split(".")
            np.testing.assert_allclose(v.numpy(), j_lora[i][name][ab],
                                       rtol=ADAPTER_RTOL, atol=ADAPTER_ATOL,
                                       err_msg=k)
    assert all(float((v - one).abs().max()) > 0 for v, one in zip(
        want.values(), port_blip2(blip_trees()).lora.state_dict().values()))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_pp_lora_step_partial_window_matches_one_process(ranks, mesh_name):
    """A trailing partial window (one microbatch where acc is ACC) steps
    on its gradient divided by ACC on the pipe as in one process."""
    want_loss, want = one_process()["blip2_partial"]
    _held_to(ranks[mesh_name], "blip2_partial", want_loss, want)
    full = one_process()["blip2"][1]
    assert any(float((want[k] - full[k]).abs().max()) > 0 for k in want)


# ---------------------------------------------------------------------------
# generation on the ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["lora", "int8", "eos"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_pp_generate_matches_one_process_and_jax(ranks, mesh_name, variant):
    every = ranks[mesh_name]
    n = MESHES[mesh_name]["pipe"]
    toks = torch.cat([r[f"gen_{variant}"][0] for i, r in enumerate(every)
                      if i % n == 0])
    valid = torch.cat([r[f"gen_{variant}"][1] for i, r in enumerate(every)
                       if i % n == 0])
    for i, r in enumerate(every):
        first = every[i - i % n]
        assert torch.equal(r[f"gen_{variant}"][0], first[f"gen_{variant}"][0])
        assert torch.equal(r[f"gen_{variant}"][1], first[f"gen_{variant}"][1])
    want_t, want_v = one_process()[f"gen_{variant}"]
    j_t, j_v = jax_generate(variant, one_process()["eos"])
    np.testing.assert_array_equal(toks.numpy(), want_t.numpy())
    np.testing.assert_array_equal(valid.numpy(), want_v.numpy())
    np.testing.assert_array_equal(toks.numpy(), j_t)
    np.testing.assert_array_equal(valid.numpy(), j_v)
    if variant == "eos":
        assert valid[0, 1] and not valid[0, 2:].any()
