"""PyTorch port, the image-only eval slice: ViT-B/16 / ViT-L/16 against
the JAX package on the same weights and inputs.

  * logits of the port (fused pre-norm blocks on their plain versions)
    against ``apply`` of the JAX package with ``GC_RCA_FUSED_ATTN=1`` (its
    Pallas kernels in interpret mode) on the tree of the JAX ``init``,
    loaded through ``load_jax_tree``: <= 1e-4 in fp32, at the full width of
    B/16 and L/16, 2 layers, 32x32 images (5 tokens);
  * ``convert_torch`` of a torchvision-layout state dict
    (``tests/torch_refs/vit_ref.py``) gives the JAX converter's tree, and
    the port's logits match the torch replica's;
  * the layer's routing rule, with a call-count spy;
  * ``cli.test_image`` writes a report CSV byte-identical to the JAX CLI's
    on ``tiny_dataset`` at 224x224: ViT-B/16 (197 tokens; a 2-layer
    checkpoint, the ``CONFIGS`` entry patched on both sides for the test),
    ShuffleNetV2 x2.0 and ResNet-18 (full size, random BatchNorm
    statistics; both CLIs fold BN), each from a torchvision-layout ``.pth``
    written from the replicas in ``tests/torch_refs``;
  * the flags that stay refused: other meshes, ``--profile_dir``, and
    training a conv backbone in ``cli.main_image``.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garbage_classification_rca_tpu.models.image import vit as jvit
from garbage_classification_rca_tpu_torch.checkpoint.from_jax import (
    export_jax_tree)
from garbage_classification_rca_tpu_torch.cli import test_image as port_cli
from garbage_classification_rca_tpu_torch.eval.harness import make_eval_step
from garbage_classification_rca_tpu_torch.models.image import vit as tvit
from garbage_classification_rca_tpu_torch.models.registry import (
    get_image_model)
from tests.test_torch_conv_backbones import _ref as _conv_ref
from tests.torch_refs.vit_ref import VisionTransformerRef

torch.set_num_threads(2)

NAMES = ["transformer_B16", "transformer_L16"]
N_LAYERS = 2


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _small(monkeypatch, name, image_size):
    """The named config at 2 layers and `image_size`, on both sides."""
    kw = dict(layers=N_LAYERS, image_size=image_size)
    monkeypatch.setitem(jvit.CONFIGS, name,
                        dataclasses.replace(jvit.CONFIGS[name], **kw))
    monkeypatch.setitem(tvit.CONFIGS, name,
                        dataclasses.replace(tvit.CONFIGS[name], **kw))


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)


def _jax_logits(name, params, x):
    p = jax.tree_util.tree_map(jnp.asarray, params)
    out, _ = jvit.apply(p, {}, jnp.asarray(x), cfg=jvit.CONFIGS[name])
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_vit_logits_match_jax(name, monkeypatch):
    _small(monkeypatch, name, 32)
    monkeypatch.setenv("GC_RCA_FUSED_ATTN", "1")    # the JAX kernel route
    params, _ = jvit.init(jax.random.PRNGKey(3), jvit.CONFIGS[name])
    params = _np_tree(params)
    rng = np.random.default_rng(0)
    # torchvision's class token is zeros at init; make it count
    params["class_token"] = rng.normal(size=params["class_token"].shape
                                       ).astype(np.float32) * 0.02
    x = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    model = get_image_model(name).load_tree(params, {}, device="cpu")
    assert len(model.layers) == N_LAYERS
    assert model.cfg.hidden == tvit.CONFIGS[name].hidden
    calls = {"attn": 0, "mlp": 0}
    for key in ("attn", "mlp"):
        real = getattr(tvit.transformer_block, f"{key}_block")
        monkeypatch.setattr(
            tvit.transformer_block, f"{key}_block",
            lambda *a, _k=key, _r=real, **kw: (
                calls.__setitem__(_k, calls[_k] + 1), _r(*a, **kw))[1])
    got = model(torch.from_numpy(x)).numpy()
    assert calls == {"attn": N_LAYERS, "mlp": N_LAYERS}   # L/16's MLP too
    want = _jax_logits(name, params, x)
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    back = export_jax_tree(model)
    np.testing.assert_array_equal(back["conv_proj.w"],
                                  params["conv_proj"]["w"])
    np.testing.assert_array_equal(back["layers.1.qkv.w"],
                                  params["layers"][1]["qkv"]["w"])
    np.testing.assert_array_equal(back["class_token"], params["class_token"])


def _ref(name, image_size, seed=0):
    cfg = tvit.CONFIGS[name]
    torch.manual_seed(seed)
    ref = VisionTransformerRef(image_size=image_size, patch=cfg.patch_size,
                               d=cfg.hidden, heads=cfg.heads, mlp=cfg.mlp,
                               layers=N_LAYERS).eval()
    with torch.no_grad():
        ref.class_token.normal_(std=0.02)
    return ref


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
def test_convert_torch_gives_the_jax_tree_and_ref_logits(name, monkeypatch):
    _small(monkeypatch, name, 32)
    ref = _ref(name, 32)
    sd = {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    want, _ = jvit.convert_torch(sd, name, num_classes=4)
    mdef = get_image_model(name)
    got, state = mdef.convert_torch(sd, num_classes=4)
    assert state == {}
    _assert_same_tree(got, _np_tree(want))
    with pytest.raises(ValueError, match="classes"):
        mdef.convert_torch(sd, num_classes=5)
    model = mdef.load_tree(got, state, device="cpu")
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(model(x), ref(x.permute(0, 3, 1, 2)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,hidden,heads,mlp,dtype,train,want", [
    (197, 768, 12, 3072, torch.bfloat16, False, "fused"),
    (197, 768, 12, 3072, torch.float32, False, "fused"),
    (197, 1024, 16, 4096, torch.bfloat16, False, "fused"),
    (5, 128, 2, 13456, torch.float32, False, "fused_attn"),  # fp32 hidden
    (225, 128, 2, 256, torch.float32, False, "mha"),
    (5, 128, 4, 256, torch.float32, False, "mha"),        # head dim 32
    (5, 128, 2, 256, torch.float32, True, "mha"),
    (5, 128, 2, 13456, torch.bfloat16, False, "fused"),   # bf16: any FFN
])
def test_layer_route_rule(n, hidden, heads, mlp, dtype, train, want):
    cfg = tvit.ViTConfig(layers=1, heads=heads, hidden=hidden, mlp=mlp)
    with torch.device("meta"):
        layer = tvit.EncoderLayer(cfg).to(dtype)
        x = torch.empty((2, n, hidden), dtype=dtype)
    assert tvit.layer_route(layer, x, heads, train=train) == want


@pytest.mark.parametrize("n,heads,mlp,train", [
    (5, 2, 256, False), (5, 2, 13456, False), (225, 2, 256, False),
    (5, 4, 256, False), (5, 2, 256, True)])
def test_every_route_computes_the_same_layer(monkeypatch, n, heads, mlp,
                                             train):
    """The route the rule picks against the torch graph of the layer
    (LayerNorm, packed qkv, softmax attention, GELU MLP)."""
    import torch.nn.functional as F

    cfg = tvit.ViTConfig(layers=1, heads=heads, hidden=128, mlp=mlp)
    g = torch.Generator().manual_seed(n + heads)
    p = tvit.EncoderLayer(cfg, generator=g)
    x = torch.randn((2, n, 128), generator=g)
    got = tvit.encoder_layer(p, x, heads, train=train)
    h = F.layer_norm(x, (128,), p.ln_1.scale, p.ln_1.bias, 1e-6)
    q, k, v = F.linear(h, p.qkv.w, p.qkv.b).chunk(3, -1)
    rs = lambda a: a.reshape(2, n, heads, -1).transpose(1, 2)
    a = F.scaled_dot_product_attention(rs(q), rs(k), rs(v))
    y = x + F.linear(a.transpose(1, 2).reshape(2, n, 128), p.out.w, p.out.b)
    h = F.layer_norm(y, (128,), p.ln_2.scale, p.ln_2.bias, 1e-6)
    want = y + F.linear(F.gelu(F.linear(h, p.fc1.w, p.fc1.b)), p.fc2.w,
                        p.fc2.b)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_image_eval_step_normalizes_and_counts():
    """harness.make_eval_step: uint8 NHWC -> ImageNet normalization in the
    compute dtype -> model -> argmax and the masked correct count."""
    seen = {}

    def model(x):
        seen["x"] = x
        return torch.tensor([[0.0, 2.0, 1.0, 0.0], [3.0, 0.0, 0.0, 0.0],
                             [0.0, 0.0, 0.0, 9.0]])

    batch = {"image": torch.full((3, 4, 4, 3), 255, dtype=torch.uint8),
             "label": torch.tensor([1, 0, 2], dtype=torch.int32),
             "valid": torch.tensor([1, 1, 0], dtype=torch.int32)}
    preds, correct = make_eval_step(model, torch.bfloat16)(batch)
    assert preds.tolist() == [1, 0, 3] and int(correct) == 2
    assert seen["x"].dtype == torch.bfloat16
    want = (1.0 - np.array([0.485, 0.456, 0.406])) / np.array(
        [0.229, 0.224, 0.225])
    np.testing.assert_allclose(seen["x"][0, 0, 0].float().numpy(), want,
                               rtol=1e-2)


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


@pytest.mark.parametrize("name", ["transformer_B16", "shuffle_net",
                                  "res18"])
def test_port_cli_report_matches_jax_cli(name, tiny_dataset, tmp_path,
                                         monkeypatch):
    from garbage_classification_rca_tpu import native
    from garbage_classification_rca_tpu.cli import test_image as jax_cli

    # the JAX batcher on its PIL + cv2 route, the one the port copies
    monkeypatch.setattr(native, "pad_resize_batch", lambda *a, **k: None)
    monkeypatch.setattr(native, "decode_enabled", lambda: False)
    ckpt = tmp_path / f"{name}.pth"
    if name == "transformer_B16":
        _small(monkeypatch, name, 224)
        torch.save(_ref(name, 224, seed=5).state_dict(), ckpt)
    else:
        torch.save(_conv_ref(name).state_dict(), ckpt)
    argv = [f"--image_model={name}", f"--model_path={ckpt}",
            f"--dataset_folder_name={tiny_dataset}",
            "--compute_dtype=float32", "--eval_batch_size=8",
            "--data_workers=2"]
    want = _run_cli(jax_cli.main, argv, tmp_path, monkeypatch, "jax")
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    got = _run_cli(port_cli.main, argv, tmp_path, monkeypatch, "port")
    assert got == want
    assert got[0].startswith(f"image_model_{name}_report_test_set_acc_")


def test_port_cli_exits_and_unported_flags(tmp_path, monkeypatch):
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    with pytest.raises(SystemExit) as e:
        port_cli.main([])                             # no --model_path
    assert e.value.code == 0
    with pytest.raises(SystemExit) as e:
        port_cli.main(["--model_path=x.pth", "--image_model=nope"])
    assert e.value.code == 1
    for flags in (["--image_model=shuffle_net", "--mesh_shape=data:4"],
                  ["--image_model=res50", "--profile_dir=p"],
                  ["--image_model=transformer_B16", "--mesh_shape=data:4"],
                  ["--image_model=transformer_B16", "--profile_dir=p"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port_cli.main(["--model_path=x.pth"] + flags)
    from garbage_classification_rca_tpu_torch.cli import main_image

    # the trainer takes the conv backbones: it goes on to read the
    # (missing) dataset
    for name in ("shuffle_net", "res50", "eff_v2_medium", "b4"):
        with pytest.raises(FileNotFoundError, match="x_Train"):
            main_image.main([f"--image_model={name}",
                             "--dataset_folder_name=x"])
    with pytest.raises(SystemExit, match="orbax"):
        port_cli.main(["--image_model=transformer_L16",
                       f"--model_path={tmp_path}"])
