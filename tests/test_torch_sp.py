"""PyTorch port, sequence parallelism of the DistilBERT encoder
(``parallel/sp.py``, the seq axis of ``parallel/mesh.py``,
``cli.test_text``'s step), over gloo ranks on the CPU.

  * ``postnorm_encode_sp`` of a tiny post-norm encoder (hidden 64, 4
    heads, FFN 128, 2 layers, eps 1e-12) at ``seq:2`` and ``data:2,seq:2``
    equals the unsharded port encode and the JAX ``postnorm_encode_sp`` at
    the same mesh within 2e-5 (JAX ``tests/test_sp.py``), on every rank;
  * an indivisible sequence raises the JAX ValueError;
  * ``distilbert_classify_sp`` at full width (768, 2 layers kept) equals
    the classifier's eval logits and the JAX ``distilbert_classify_sp``;
  * ``make_text_eval_step`` on a seq axis predicts what the data-axis
    step predicts; BERT on a seq axis exits 1.

One ``multihost.launch`` serves the two-rank cases, another the
four-rank ones.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from garbage_classification_rca_tpu.models.text import distilbert as jdb
from garbage_classification_rca_tpu.parallel import mesh as jmesh
from garbage_classification_rca_tpu.parallel import sp as jsp
from garbage_classification_rca_tpu_torch.checkpoint.from_jax import (
    load_jax_tree)
from garbage_classification_rca_tpu_torch.cli.test_text import (
    make_text_eval_step)
from garbage_classification_rca_tpu_torch.models.registry import (
    get_text_model)
from garbage_classification_rca_tpu_torch.models.text.encoder_common import (
    PostNormLayer, postnorm_layer)
from garbage_classification_rca_tpu_torch.nn import core
from garbage_classification_rca_tpu_torch.parallel import sp
from garbage_classification_rca_tpu_torch.parallel.mesh import DataMesh
from tests.test_sp import (FFN, HEADS, HIDDEN, LN_EPS, MAX_POS, VOCAB,
                           tiny_encoder)
from tests.test_torch_multihost import launch_script

torch.set_num_threads(2)

TOL = 2e-5                                  # the JAX tests/test_sp.py bar
ENCODE_CASES = {"seq:2": [(3, 16), (2, 32)], "data:2,seq:2": [(4, 16)]}


class TinyEncoder(nn.Module):
    """The JAX test's post-norm encoder tree as a port module."""

    def __init__(self, layers=2):
        super().__init__()
        self.word_emb = core.Embedding(VOCAB, HIDDEN)
        self.pos_emb = core.Embedding(MAX_POS, HIDDEN)
        self.ln_emb = core.LayerNorm(HIDDEN, LN_EPS)
        self.layers = nn.ModuleList(PostNormLayer(HIDDEN, FFN, LN_EPS)
                                    for _ in range(layers))


@functools.lru_cache(maxsize=None)
def tiny_tree():
    return jax.tree_util.tree_map(np.asarray,
                                  tiny_encoder(jax.random.PRNGKey(0)))


def batch(b, l, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (b, l)).astype(np.int32)
    mask = np.ones((b, l), np.int32)
    mask[0, -3:] = 0
    return ids, mask


@functools.lru_cache(maxsize=None)
def db_tree():
    """DistilBERT at full width, 2 layers kept (the JAX test's)."""
    params, _ = jdb.init(jax.random.PRNGKey(3))
    params["encoder"]["layers"] = params["encoder"]["layers"][:2]
    return jax.tree_util.tree_map(np.asarray, params)


def db_batch():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, jdb.VOCAB, (4, 64)).astype(np.int32)
    mask = np.ones((4, 64), np.int32)
    mask[1, -10:] = 0
    mask[3, -40:] = 0
    label = rng.integers(0, 4, (4,)).astype(np.int32)
    return ids, mask, label


WORKER = """
    import sys
    import torch
    torch.set_num_threads(1)
    from garbage_classification_rca_tpu_torch.parallel.multihost import (
        initialize_from_env, make_mesh)
    from tests.test_torch_sp import rank_work

    spec = torch.load(sys.argv[1], weights_only=False)
    mesh = make_mesh(initialize_from_env("cpu"), spec["axes"])
    torch.save(rank_work(mesh, spec), f"rank{mesh.rank}.pt")
"""


def rank_work(mesh, spec):
    """This rank's encodes of `spec`'s cases (its data rows), the
    classifier's logits and the seq-axis eval step's predictions."""
    out = {}
    enc = TinyEncoder()
    load_jax_tree(enc, spec["tiny"])
    with torch.no_grad():
        for b, l in spec["cases"]:
            ids, mask = (torch.from_numpy(a)[mesh.local_rows(b)]
                         for a in batch(b, l))
            out[(b, l)] = sp.postnorm_encode_sp(
                enc, ids, mask, mesh, heads=HEADS, ln_eps=LN_EPS).numpy()
        model = get_text_model("distilbert").load_tree(spec["db"], {},
                                                       device="cpu")
        ids, mask, label = (torch.from_numpy(a)[mesh.local_rows(4)]
                            for a in db_batch())
        out["logits"] = sp.distilbert_classify_sp(model, ids, mask,
                                                  mesh).numpy()
        step = make_text_eval_step(model, mesh, text_model="distilbert")
        preds, c = step({"input_ids": ids, "attention_mask": mask,
                         "label": label,
                         "valid": torch.ones_like(label)})
        out["preds"], out["correct"] = preds.numpy(), int(c)
    return out


def _launch(tmp_path_factory, spec_str, nproc):
    from tests.test_torch_tp import _axes

    d = tmp_path_factory.mktemp("sp")
    spec = d / "spec.pt"
    torch.save({"axes": _axes(spec_str), "cases": ENCODE_CASES[spec_str],
                "tiny": tiny_tree(), "db": db_tree()}, spec)
    launch_script(d, WORKER, [spec], nproc=nproc)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(nproc)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{mesh spec: every rank's results}: one two-rank and one four-rank
    launch."""
    return {"seq:2": _launch(tmp_path_factory, "seq:2", 2),
            "data:2,seq:2": _launch(tmp_path_factory, "data:2,seq:2", 4)}


def _rows(mesh_spec, rank, b):
    data = 2 if mesh_spec.startswith("data:2") else 1
    n = b // data
    d = rank // 2 if data == 2 else 0
    return slice(d * n, (d + 1) * n)


@pytest.mark.parametrize("mesh_spec,b,l", [
    (m, b, l) for m, cases in ENCODE_CASES.items() for b, l in cases])
def test_sp_encode_matches_unsharded_and_jax(ranks, mesh_spec, b, l):
    tree = tiny_tree()
    enc = TinyEncoder()
    load_jax_tree(enc, tree)
    ids, mask = batch(b, l)
    with torch.no_grad():
        pos = torch.arange(l)
        h = enc.ln_emb(enc.word_emb(torch.from_numpy(ids))
                       + enc.pos_emb(pos)[None])
        for p in enc.layers:
            h = postnorm_layer(p, h, torch.from_numpy(mask), HEADS)
    want = h.numpy()
    jm = jmesh.make_mesh(mesh_spec, jax.devices()[:4 if "data" in mesh_spec
                                                   else 2])
    want_j = np.asarray(jax.jit(lambda p, i, m: jsp.postnorm_encode_sp(
        p, i, m, jm, heads=HEADS, ln_eps=LN_EPS))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(ids),
        jnp.asarray(mask)))
    for r, got in enumerate(ranks[mesh_spec]):
        rows = _rows(mesh_spec, r, b)
        np.testing.assert_allclose(got[(b, l)], want[rows], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got[(b, l)], want_j[rows], rtol=TOL,
                                   atol=TOL)


def test_sp_rejects_indivisible_sequence():
    enc = TinyEncoder()
    ids = torch.ones((2, 12), dtype=torch.int32)
    with pytest.raises(ValueError, match="does not divide"):
        sp.postnorm_encode_sp(enc, ids, torch.ones_like(ids),
                              DataMesh(0, 8, axes=(("seq", 8),)),
                              heads=HEADS, ln_eps=LN_EPS)


@pytest.mark.parametrize("mesh_spec", list(ENCODE_CASES))
def test_sp_distilbert_classifier_logits(ranks, mesh_spec):
    """Full DistilBERT geometry, 2 layers: the SP logits equal the
    classifier's and the JAX ``distilbert_classify_sp``'s on every rank;
    the eval step on the seq axis predicts as the plain step."""
    tree = db_tree()
    ids, mask, label = db_batch()
    model = get_text_model("distilbert").load_tree(tree, {}, device="cpu")
    with torch.no_grad():
        want = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    jm = jmesh.make_mesh(mesh_spec, jax.devices()[:4 if "data" in mesh_spec
                                                   else 2])
    want_j = np.asarray(jax.jit(lambda p, i, m: jsp.distilbert_classify_sp(
        p, i, m, jm))(jax.tree_util.tree_map(jnp.asarray, tree),
                      jnp.asarray(ids), jnp.asarray(mask)))
    step = make_text_eval_step(model)
    with torch.no_grad():
        preds, _ = step({"input_ids": torch.from_numpy(ids),
                         "attention_mask": torch.from_numpy(mask),
                         "label": torch.from_numpy(label),
                         "valid": torch.ones(4, dtype=torch.int32)})
    for r, got in enumerate(ranks[mesh_spec]):
        rows = _rows(mesh_spec, r, 4)
        np.testing.assert_allclose(got["logits"], want[rows], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got["logits"], want_j[rows], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(got["preds"], preds.numpy()[rows])
        assert got["correct"] == int((preds.numpy()[rows]
                                      == label[rows]).sum())


def test_sp_eval_step_refuses_other_text_models():
    model = get_text_model("distilbert").load_tree(db_tree(), {},
                                                   device="cpu")
    mesh = DataMesh(0, 2, axes=(("seq", 2),))
    with pytest.raises(SystemExit) as e:
        make_text_eval_step(model, mesh, text_model="bert")
    assert e.value.code == 1
