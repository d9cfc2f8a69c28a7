"""PyTorch port, the text-only eval slice: DistilBERT / BERT / RoBERTa
classifiers against the JAX package on the same weights and inputs.

  * logits of the port (fused post-norm blocks on their plain versions)
    against ``apply`` of the JAX package with ``GC_RCA_FUSED_ATTN=1`` (its
    Pallas kernels in interpret mode) on the tree of the JAX ``init``,
    loaded through ``load_jax_tree``: <= 1e-4 in fp32 at 2 layers, full
    width; in bf16 (where the JAX side takes its fused post-norm blocks)
    <= 3e-2, the bar of the JAX package's own tower tests;
  * ``convert_torch`` of a synthesized HF-layout state dict gives the same
    tree as the JAX converter, and the port's logits match HF's;
  * ``cli.test_text`` writes a report CSV byte-identical to the JAX CLI's on
    the ``tiny_dataset`` fixture (2-layer checkpoints; the JAX modules'
    ``LAYERS`` is patched for the test, no JAX file changes).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.models.text import bert as jbert
from garbage_classification_rca_tpu.models.text import distilbert as jdistil
from garbage_classification_rca_tpu.models.text import roberta as jroberta
from garbage_classification_rca_tpu_torch.checkpoint.from_jax import (
    export_jax_tree)
from garbage_classification_rca_tpu_torch.cli import test_text as port_cli
from garbage_classification_rca_tpu_torch.models.registry import (
    get_text_model)
from garbage_classification_rca_tpu_torch.models.text import (
    encoder_common as tenc)

torch.set_num_threads(2)

VOCABS = os.path.join(os.path.dirname(__file__), "fixtures", "vocab")
JAX_MODS = {"distilbert": jdistil, "bert": jbert, "roberta": jroberta}
# the module whose LAYERS the JAX init / converter reads
LAYER_OWNER = {"distilbert": jdistil, "bert": jbert, "roberta": jbert}
NAMES = sorted(JAX_MODS)
N_LAYERS = 2


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _batch(vocab, seed=0, b=3, n=16):
    rng = np.random.default_rng(seed)
    lens = np.array([[n], [9], [4]])[:b]
    mask = (np.arange(n)[None, :] < lens).astype(np.int32)
    ids = rng.integers(5, vocab, (b, n)).astype(np.int32) * mask
    return ids, mask


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)


@pytest.fixture(scope="module")
def jax_trees():
    """{name: numpy params} of the JAX ``init`` at 2 layers, full width."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdistil, "LAYERS", N_LAYERS)
        mp.setattr(jbert, "LAYERS", N_LAYERS)
        for i, name in enumerate(NAMES):
            params, _ = JAX_MODS[name].init(jax.random.PRNGKey(i))
            out[name] = _np_tree(params)
    return out


def _jax_logits(name, params, ids, mask, dtype=jnp.float32):
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
    out, _ = JAX_MODS[name].apply(p, {}, (jnp.asarray(ids),
                                           jnp.asarray(mask)), train=False)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_classifier_logits_match_jax(name, jax_trees, monkeypatch):
    monkeypatch.setenv("GC_RCA_FUSED_ATTN", "1")    # the JAX kernel route
    params = jax_trees[name]
    ids, mask = _batch(20000)
    model = get_text_model(name).load_tree(params, {}, device="cpu")
    assert len(model.encoder.layers) == N_LAYERS
    got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    want = _jax_logits(name, params, ids, mask)
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    # the tree round-trips through the port's module
    back = export_jax_tree(model)
    np.testing.assert_array_equal(back["encoder.layers.1.fc1.w"],
                                  params["encoder"]["layers"][1]["fc1"]["w"])
    np.testing.assert_array_equal(back["head.w"], params["head"]["w"])


@pytest.mark.parametrize("name", NAMES)
def test_classifier_bf16_fused_blocks_match_jax_fused_blocks(
        name, jax_trees, monkeypatch):
    """bf16, the eval CLIs' dtype: both sides take their fused post-norm
    blocks (spied on both)."""
    from garbage_classification_rca_tpu.models.text import (
        encoder_common as jenc)

    monkeypatch.setenv("GC_RCA_FUSED_ATTN", "1")
    calls = {"jax": 0, "port": 0}
    j_real = jenc.transformer_block.postnorm_attn_block
    t_real = tenc.transformer_block.postnorm_attn_block

    def j_spy(*a, **kw):
        calls["jax"] += 1
        return j_real(*a, **kw)

    def t_spy(*a, **kw):
        calls["port"] += 1
        return t_real(*a, **kw)

    monkeypatch.setattr(jenc.transformer_block, "postnorm_attn_block", j_spy)
    monkeypatch.setattr(tenc.transformer_block, "postnorm_attn_block", t_spy)
    params = jax_trees[name]
    ids, mask = _batch(20000, seed=1)
    model = get_text_model(name).load_tree(params, {}, device="cpu").to(
        torch.bfloat16)
    got = model(torch.from_numpy(ids), torch.from_numpy(mask)).float().numpy()
    want = _jax_logits(name, params, ids, mask, jnp.bfloat16)
    assert calls == {"jax": N_LAYERS, "port": N_LAYERS}
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


def _hf_model(name):
    import transformers as tf

    torch.manual_seed(7)
    if name == "distilbert":
        return tf.DistilBertModel(tf.DistilBertConfig(n_layers=N_LAYERS))
    if name == "bert":
        return tf.BertModel(tf.BertConfig(num_hidden_layers=N_LAYERS))
    return tf.RobertaModel(tf.RobertaConfig(
        vocab_size=50265, max_position_embeddings=514, type_vocab_size=1,
        num_hidden_layers=N_LAYERS, pad_token_id=1, layer_norm_eps=1e-12))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{name: (HF encoder, head, path)}: reference-layout classifier .pth
    files (encoder under ``model.``, head under ``out.``), 2 layers."""
    out = {}
    d = tmp_path_factory.mktemp("text_ckpt")
    for name in NAMES:
        enc = _hf_model(name).eval()
        head = torch.nn.Linear(768, 4)
        sd = {"model." + k: v for k, v in enc.state_dict().items()}
        sd["out.weight"] = head.weight.detach()
        sd["out.bias"] = head.bias.detach()
        path = d / f"{name}_cls.pth"
        torch.save(sd, path)
        out[name] = (enc, head, path)
    return out


def _numpy_sd(path):
    from garbage_classification_rca_tpu_torch.checkpoint.torch_convert import (
        load_torch_state_dict)

    return load_torch_state_dict(str(path))


def _assert_same_tree(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), path
        for k in b:
            _assert_same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}.{i}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), path)


@pytest.mark.parametrize("name", NAMES)
def test_convert_torch_gives_the_jax_tree_and_hf_logits(name, checkpoints,
                                                        monkeypatch):
    enc, head, path = checkpoints[name]
    sd = _numpy_sd(path)
    monkeypatch.setattr(LAYER_OWNER[name], "LAYERS", N_LAYERS)
    want, _ = JAX_MODS[name].convert_torch(dict(sd), num_classes=4)
    mdef = get_text_model(name)
    got, state = mdef.convert_torch(sd, num_classes=4)
    assert state == {}
    _assert_same_tree(got, _np_tree(want))
    with pytest.raises(ValueError, match="class-count"):
        mdef.convert_torch(sd, num_classes=5)

    model = mdef.load_tree(got, state, device="cpu")
    ids, mask = _batch(20000, seed=2)
    logits = model(torch.from_numpy(ids), torch.from_numpy(mask))
    hf = head(enc(torch.from_numpy(ids).long(),
                  attention_mask=torch.from_numpy(mask).long())[0][:, 0])
    torch.testing.assert_close(logits, hf, rtol=1e-4, atol=1e-4)


def test_bert_hidden_states_match_jax(jax_trees):
    """``output_hidden_states`` (kept for the hierarchical head): the
    embeddings output and every layer's, against the JAX encoder."""
    from garbage_classification_rca_tpu_torch.models.text import bert as tbert

    params = jax_trees["bert"]
    ids, mask = _batch(20000, seed=3)
    model = get_text_model("bert").load_tree(params, {}, device="cpu")
    last, hiddens = tbert.encode(model.encoder, torch.from_numpy(ids),
                                 torch.from_numpy(mask),
                                 output_hidden_states=True)
    jp = jax.tree_util.tree_map(jnp.asarray, params["encoder"])
    jlast, jhiddens = jbert.encode(jp, jnp.asarray(ids), jnp.asarray(mask),
                                   output_hidden_states=True)
    assert len(hiddens) == len(jhiddens) == N_LAYERS + 1
    assert hiddens[-1] is last
    # padded positions of a row are not compared: their queries are real
    # but nothing reads them
    keep = mask.astype(bool)
    for h, jh in zip(hiddens, jhiddens):
        np.testing.assert_allclose(h.numpy()[keep], np.asarray(jh)[keep],
                                   rtol=1e-4, atol=1e-4)


def test_roberta_position_ids_follow_the_mask(jax_trees):
    """pos = cumsum(mask) * mask + 1: a padded tail reads position 1."""
    from garbage_classification_rca_tpu_torch.models.text import (
        roberta as troberta)

    params = jax_trees["roberta"]
    model = get_text_model("roberta").load_tree(params, {}, device="cpu")
    ids, mask = _batch(40000, seed=4)
    seen = {}
    real = model.encoder.pos_emb.forward
    model.encoder.pos_emb.forward = lambda i: (seen.setdefault("ids", i),
                                               real(i))[1]
    troberta.encode(model.encoder, torch.from_numpy(ids),
                    torch.from_numpy(mask))
    want = np.cumsum(mask, 1) * mask + 1
    np.testing.assert_array_equal(seen["ids"].numpy(), want)
    assert tuple(model.encoder.pos_emb.w.shape) == (514, 768)
    assert tuple(model.encoder.word_emb.w.shape) == (50265, 768)


def _csv_bytes(root):
    csvs = glob.glob(os.path.join(root, "**", "*.csv"), recursive=True)
    assert len(csvs) == 1, csvs
    with open(csvs[0], "rb") as f:
        return os.path.basename(csvs[0]), f.read()


def _run_cli(main, argv, tmp_path, monkeypatch, sub):
    d = tmp_path / sub
    d.mkdir(exist_ok=True)
    monkeypatch.chdir(d)
    main(argv)
    monkeypatch.chdir(tmp_path)
    return _csv_bytes(str(d / "test_set_reports"))


@pytest.mark.parametrize("name", NAMES)
def test_port_cli_report_matches_jax_cli(name, checkpoints, tiny_dataset,
                                         tmp_path, monkeypatch):
    from garbage_classification_rca_tpu.cli import test_text as jax_cli

    _, _, ckpt = checkpoints[name]
    vocab = os.path.join(VOCABS, "bpe" if name == "roberta" else "wordpiece")
    argv = [f"--text_model={name}", f"--model_path={ckpt}",
            f"--dataset_folder_name={tiny_dataset}", f"--vocab_dir={vocab}",
            "--compute_dtype=float32", "--eval_batch_size=8"]
    monkeypatch.setattr(LAYER_OWNER[name], "LAYERS", N_LAYERS)
    want = _run_cli(jax_cli.main, argv, tmp_path, monkeypatch, "jax")
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    got = _run_cli(port_cli.main, argv, tmp_path, monkeypatch, "port")
    assert got == want
    assert got[0].startswith(f"text_model_{name}_report_test_set_acc_")


def test_port_cli_exits_and_unported_flags(tmp_path, monkeypatch):
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    with pytest.raises(SystemExit) as e:
        port_cli.main([])                             # no --model_path
    assert e.value.code == 0
    with pytest.raises(SystemExit) as e:
        port_cli.main(["--model_path=x.pth", "--text_model=nope"])
    assert e.value.code == 1
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_cli.main(["--model_path=x.pth", "--mesh_shape=data:2,seq:4"])
    # multi-host runs: the JAX package's variables, all of them
    monkeypatch.setenv("GC_RCA_MULTIHOST", "1")
    with pytest.raises(SystemExit, match="needs GC_RCA_COORDINATOR"):
        port_cli.main(["--model_path=x.pth"])
    monkeypatch.delenv("GC_RCA_MULTIHOST")
    with pytest.raises(SystemExit, match="orbax"):
        port_cli.main([f"--model_path={tmp_path}"])
