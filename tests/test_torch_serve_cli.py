"""PyTorch port, ``cli.serve`` and ``cli.blip2_test --max_new_tokens`` > 1
against the JAX package's CLIs (``GC_RCA_TINY_BLIP2=1``, the CPU, fp32),
on one peft-wrapped HF ``Blip2ForConditionalGeneration`` ``.pth`` at the
tiny geometry with the adapters' B drawn non-zero:

  * ``cli.serve``: text and image requests with their own budgets, a line
    that does not parse, a non-object line and a request with a bad field;
    every valid request is answered exactly once, the error lines are
    written, and each greedy response line is byte-identical to the JAX
    server's for the same request (completion order hangs on the reader
    thread's timing, so lines are matched by id);
  * ``cli.blip2_test --max_new_tokens=4``: the report CSV byte-identical to
    the JAX CLI's, greedy and with ``--int8_weights --kv_cache_dtype=int8``;
    the sampled run (``--gen_temperature``) is the port's own draw and
    gives the same report again from the same ``--gen_seed``.

The CPU rows are bit-identical across batch sizes (``tests/
test_torch_serving.py``), so no near-tie rule is needed here.
"""

import glob
import io
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

BPE = os.path.join(os.path.dirname(__file__), "fixtures", "vocab", "bpe")


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    monkeypatch.setenv("GC_RCA_TINY_BLIP2", "1")
    monkeypatch.setenv("GC_RCA_PLATFORM", "cpu")
    monkeypatch.delenv("GC_RCA_FUSED_ATTN", raising=False)


@pytest.fixture(scope="module")
def blip_pth(tmp_path_factory):
    from peft import LoraConfig, get_peft_model
    from transformers import (Blip2Config, Blip2ForConditionalGeneration,
                              Blip2QFormerConfig, Blip2VisionConfig,
                              OPTConfig)

    hf = Blip2Config(
        vision_config=Blip2VisionConfig(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, image_size=224, patch_size=14).to_dict(),
        qformer_config=Blip2QFormerConfig(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, encoder_hidden_size=64,
            cross_attention_frequency=2).to_dict(),
        text_config=OPTConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            ffn_dim=128, vocab_size=50272, max_position_embeddings=256,
            word_embed_proj_dim=64).to_dict(),
        num_query_tokens=8)
    tm = Blip2ForConditionalGeneration(hf).eval()
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            a = rng.normal(0, 0.1, tuple(p.shape)).astype(np.float32)
            if "norm" in name.lower() and name.endswith("weight"):
                a += 1.0
            p.copy_(torch.from_numpy(a))
    pm = get_peft_model(tm, LoraConfig(r=4, lora_alpha=8, lora_dropout=0.05,
                                       bias="none",
                                       target_modules=["q_proj", "k_proj"]))
    with torch.no_grad():
        for n, p in pm.named_parameters():
            if "lora_B" in n:
                p.copy_(torch.from_numpy(rng.normal(
                    0, 0.1, tuple(p.shape)).astype(np.float32)))
    path = tmp_path_factory.mktemp("serve_ckpt") / "BLIP2.pth"
    torch.save({"model_state_dict": pm.state_dict()}, path)
    return str(path)


def _images(root, n):
    return sorted(glob.glob(os.path.join(str(root), "*", "*.jpg")))[:n]


def _serve(main, raw, argv):
    out = io.StringIO()
    assert main(argv, stdin=io.StringIO(raw), stdout=out) == 0
    return out.getvalue().splitlines()


def test_serve_lines_match_the_jax_server(blip_pth, tiny_dataset, capsys):
    from garbage_classification_rca_tpu.cli import serve as jserve
    from garbage_classification_rca_tpu_torch.cli import serve as tserve

    imgs = _images(tiny_dataset, 3)
    reqs = [{"id": f"t{i}", "text": t, "max_new": n} for i, (t, n) in
            enumerate([("Question: which bin? Answer:", 5),
                       ("hello world", 2), ("a battery pack", 1),
                       ("banana peel in the bin", 4), ("", 5),
                       ("paint can", 3)])]
    reqs += [{"id": f"i{i}", "text": "Question: which bin? Answer:",
              "image": p, "max_new": 2 + i} for i, p in enumerate(imgs)]
    lines = [json.dumps(r) for r in reqs]
    lines[3:3] = ["{not json", "[1, 2]",
                  json.dumps({"id": "bad", "text": 5}),
                  json.dumps({"id": "gone", "text": "x",
                              "image": "/does/not/exist.jpg"})]
    raw = "\n".join(lines) + "\n"
    argv = [f"--model_path={blip_pth}", f"--vocab_dir={BPE}",
            "--compute_dtype=float32", "--max_prompt=16",
            "--max_new_tokens=5", "--serve_slots=2", "--steps_per_sync=2"]
    want = _serve(jserve.main, raw, argv)
    capsys.readouterr()
    got = _serve(tserve.main, raw, argv)
    assert capsys.readouterr().err.count("bad request line") == 2
    by_id = {}
    for line in got:
        d = json.loads(line)
        assert d["id"] not in by_id, d["id"]        # answered exactly once
        by_id[d["id"]] = line
    assert set(by_id) == {r["id"] for r in reqs} | {"bad", "gone"}
    assert "error" in json.loads(by_id["bad"])
    assert "error" in json.loads(by_id["gone"])
    assert sorted(got) == sorted(want)
    for r in reqs:
        assert json.loads(by_id[r["id"]])["n_tokens"] <= r["max_new"]
    assert any(json.loads(by_id[r["id"]])["tokens"] for r in reqs)


def test_serve_refuses_image_prompts_without_room(blip_pth, tiny_dataset):
    from garbage_classification_rca_tpu_torch.cli import serve as tserve

    img = _images(tiny_dataset, 1)[0]
    raw = "\n".join(json.dumps(r) for r in (
        {"id": "i0", "text": "a", "image": img},
        {"id": "t0", "text": "ok"})) + "\n"
    out = [json.loads(l) for l in _serve(tserve.main, raw, [
        f"--model_path={blip_pth}", f"--vocab_dir={BPE}",
        "--compute_dtype=float32", "--max_prompt=8",
        "--max_new_tokens=2", "--serve_slots=1"])]
    got = {d["id"]: d for d in out}
    assert "max_prompt" in got["i0"]["error"]
    assert got["t0"]["n_tokens"] >= 1
    # the model axis runs over M ranks (tests/test_torch_tp_cli.py): in
    # a one-process run it names the launcher; the pipe axis raises
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node=2"):
        tserve.main(["--mesh_shape=data:1,model:2"])
    with pytest.raises(NotImplementedError, match="item 7"):
        tserve.main(["--mesh_shape=data:1,pipe:2"])


def _csv(root):
    csvs = glob.glob(os.path.join(root, "**", "*.csv"), recursive=True)
    assert len(csvs) == 1, csvs
    with open(csvs[0], "rb") as f:
        return os.path.relpath(csvs[0], root), f.read()


def _run(main, argv, tmp_path, monkeypatch, sub):
    d = tmp_path / sub
    d.mkdir()
    monkeypatch.chdir(d)
    acc = main(argv)
    monkeypatch.chdir(tmp_path)
    return acc, _csv(str(d / "test_set_reports"))


@pytest.mark.parametrize("flags", [[], ["--int8_weights",
                                        "--kv_cache_dtype=int8"]])
def test_blip2_test_generate_report_matches_jax(flags, blip_pth,
                                                tiny_dataset, tmp_path,
                                                monkeypatch):
    from garbage_classification_rca_tpu.cli.blip2_test import main as jmain
    from garbage_classification_rca_tpu_torch.cli.blip2_test import (
        main as tmain)

    argv = [f"--dataset_folder_name={tiny_dataset}", f"--vocab_dir={BPE}",
            f"--model_path={blip_pth}", "--compute_dtype=float32",
            "--eval_batch_size=5", "--data_workers=2",
            "--max_new_tokens=4"] + flags
    acc_j, want = _run(jmain, argv, tmp_path, monkeypatch, "jax")
    acc_t, got = _run(tmain, argv, tmp_path, monkeypatch, "port")
    assert acc_t == acc_j
    assert got == want


def test_blip2_test_sampled_is_reproducible(blip_pth, tiny_dataset,
                                            tmp_path, monkeypatch):
    from garbage_classification_rca_tpu_torch.cli.blip2_test import (
        evaluate)
    from garbage_classification_rca_tpu_torch.config import args_parser

    argv = [f"--dataset_folder_name={tiny_dataset}", f"--vocab_dir={BPE}",
            f"--model_path={blip_pth}", "--compute_dtype=float32",
            "--eval_batch_size=5", "--data_workers=2", "--max_new_tokens=4",
            "--gen_temperature=0.7", "--gen_top_k=50", "--gen_top_p=0.9",
            "--gen_seed=3"]
    a = evaluate(args_parser(argv))[2]
    b = evaluate(args_parser(argv))[2]
    assert len(a) == 12 and np.array_equal(a, b)
