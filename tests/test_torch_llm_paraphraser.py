"""PyTorch port, the Llama paraphraser behind ``GC_RCA_LLM_PATH``
(``data/synonymize.make_hf_llm_fn``) and its parts, each against what the
JAX package runs through transformers, on the CPU with tiny random
Llamas (no Llama weights, tokenizer or Meta template is in the
repository, and nothing is downloaded):

  * ``checkpoint/hf_dir``: safetensors files (F32, F16, BF16; one file
    and shards with an index) read as ``safetensors.torch.load_file`` and
    ``from_pretrained`` read them, the model's dtype as
    ``from_pretrained`` gives it (fp32 from a bf16 file), a missing
    directory raising; ``chip_smoke.write_safetensors`` read back by
    ``safetensors``;
  * ``data/tokenizer.HFTokenizer`` against ``tokenizers`` (ids, decode
    with and without the special tokens) and transformers' left padding
    and ``batch_decode``, on a GPT-2 ByteLevel tokenizer trained as
    ``tests/test_llm_backends.py`` trains it and on one of Llama-3's form
    (``chip_smoke.llama3_tokenizer_spec``: the Split pattern, specials);
  * ``data/chat_template`` byte-identical to ``apply_chat_template`` on
    the JAX test's ``CHAT_TEMPLATE`` and on ``chip_smoke``'s
    Llama-3-style template, ``raise_exception`` included;
  * ``models/text/llama`` logits against ``LlamaForCausalLM`` (1e-5 of
    the largest |logit|, fp32) at GQA 4 / 2, with llama3 RoPE scaling,
    tied and untied, left-padded; its cached decode against the forward;
  * ``make_hf_llm_fn(path)`` against the JAX package's on one saved
    directory and seed: the same strings, and each step's warped
    distribution within 1e-6 of transformers' ``generate`` scores;
  * the batching and single-string contracts of
    ``tests/test_llm_backends.py``.
"""

import json
import os
import socket

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(2)

BPE = os.path.join(os.path.dirname(__file__), "fixtures", "vocab", "bpe")
# the JAX test's template (tests/test_llm_backends.py)
CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "<|{{ message['role'] }}|>{{ message['content'] }}\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>{% endif %}"
)
TEXTS = ["water bottle", "Héllo wörld 12345 678 don't I'm WE'LL\n\n new  "
         "lines\t tab\r\n", "<|begin_of_text|>old battery<|eot_id|>x",
         "日本語 テキスト 🚮 ½ ١٢٣", "   lead and trail   ", "a<|user|>b</s>",
         "it's 3.14159 — 1,000,000!", ""]


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """transformers must read the local directories only."""
    def refuse(self, address):
        if isinstance(address, tuple) and address[0] not in (
                "localhost", "127.0.0.1", "::1"):
            raise OSError(f"no network in this test ({address})")
        return real(self, address)

    real = socket.socket.connect
    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")


def _gpt2_tokenizer():
    """The JAX test's trained ByteLevel BPE (``tokenizers`` object)."""
    from tokenizers import ByteLevelBPETokenizer

    corpus = ["water bottle plastic recyclable", "banana peel compost",
              "old battery recycling", "<|system|>", "<|user|>",
              "<|assistant|>", "sentence rewrite synonyms"]
    raw = ByteLevelBPETokenizer()
    raw.train_from_iterator(corpus, vocab_size=300, min_frequency=1,
                            special_tokens=["<s>", "</s>", "<unk>"])
    return raw._tokenizer


def _tokenizers(kind):
    """(tokenizers.Tokenizer, its tokenizer.json as a dict, eos)."""
    from tokenizers import Tokenizer

    if kind == "gpt2":
        tok = _gpt2_tokenizer()
        return tok, json.loads(tok.to_str()), "</s>"
    spec = chip_smoke.llama3_tokenizer_spec(BPE)
    return Tokenizer.from_str(json.dumps(spec)), spec, "<|eot_id|>"


# -- the safetensors reader ------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_safetensors_reader_matches_safetensors(dtype, tmp_path):
    from safetensors.torch import load_file, save_file

    from garbage_classification_rca_tpu_torch.checkpoint import hf_dir

    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(7, 5, generator=g).to(dtype),
               "b": torch.randn(3, generator=g).to(dtype),
               "scalar": torch.tensor(1.5).to(dtype),
               "empty": torch.zeros(0, 4, dtype=dtype),
               "c.3.d": torch.randn(2, 3, 4, generator=g).to(dtype)}
    for writer, name in ((save_file, "lib.safetensors"),
                         (chip_smoke.write_safetensors, "own.safetensors")):
        path = str(tmp_path / name)
        writer(tensors, path) if writer is save_file else writer(path,
                                                                 tensors)
        want, got = load_file(path), hf_dir.read_safetensors(path)
        assert got.keys() == want.keys() == tensors.keys()
        for k, v in want.items():
            assert got[k].dtype == v.dtype == dtype, k
            assert got[k].shape == v.shape and torch.equal(got[k], v), k
            assert torch.equal(v, tensors[k]), k


def test_sharded_bf16_directory_loads_as_from_pretrained(tmp_path):
    """A bf16 directory in four shards: the reader's tensors are the
    index's, and the port's model holds them in fp32, as
    ``AutoModelForCausalLM.from_pretrained`` does."""
    from safetensors.torch import load_file
    from transformers import AutoModelForCausalLM, LlamaConfig

    from garbage_classification_rca_tpu_torch.checkpoint import hf_dir
    from garbage_classification_rca_tpu_torch.data import synonymize

    torch.manual_seed(0)
    hf = _hf_llama(LlamaConfig(vocab_size=300, hidden_size=32,
                               intermediate_size=64, num_hidden_layers=2,
                               num_attention_heads=4, num_key_value_heads=2))
    hf.to(torch.bfloat16).save_pretrained(tmp_path, max_shard_size="20KB")
    index = json.load(open(tmp_path / "model.safetensors.index.json"))
    assert len(set(index["weight_map"].values())) > 1
    sd = hf_dir.read_weights(str(tmp_path))
    assert sd.keys() == index["weight_map"].keys()
    for k, shard in index["weight_map"].items():
        assert torch.equal(sd[k], load_file(tmp_path / shard)[k]), k
    ref = AutoModelForCausalLM.from_pretrained(tmp_path)
    _write_tokenizer(tmp_path, "llama3")
    model, _, gen = synonymize.load_llm(str(tmp_path), "cpu")
    assert ref.dtype == torch.float32
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    for k, v in ref.state_dict().items():
        assert torch.equal(model.hf_state_dict()[k], v), k
    assert gen["eos_token_id"] == 2
    with pytest.raises(FileNotFoundError, match="not a model directory"):
        synonymize.load_llm(str(tmp_path / "missing"), "cpu")


# -- the tokenizer ---------------------------------------------------------

@pytest.mark.parametrize("kind", ["gpt2", "llama3"])
def test_tokenizer_json_matches_tokenizers(kind, tmp_path):
    from transformers import PreTrainedTokenizerFast

    from garbage_classification_rca_tpu_torch.data.tokenizer import (
        HFTokenizer)

    lib, spec, eos = _tokenizers(kind)
    for clean in (False, True):
        ours = HFTokenizer(spec, {"eos_token": eos,
                                  "clean_up_tokenization_spaces": clean})
        for text in TEXTS:
            want = lib.encode(text, add_special_tokens=False).ids
            assert ours.encode(text) == want, text
            if not clean:       # transformers' cleanup: below
                for skip in (True, False):
                    assert ours.decode(want, skip) == lib.decode(want, skip)
        # transformers' left padding (pad = eos) and batch_decode
        hf = PreTrainedTokenizerFast(tokenizer_object=lib, eos_token=eos,
                                     clean_up_tokenization_spaces=clean)
        hf.padding_side = "left"
        hf.pad_token = hf.eos_token
        enc = hf(TEXTS[:-1], add_special_tokens=False, padding=True)
        ids, mask = ours.batch(TEXTS[:-1])
        assert ids.tolist() == enc["input_ids"]
        assert mask.tolist() == enc["attention_mask"]
        for skip in (True, False):
            assert ours.batch_decode(ids.tolist(), skip) == \
                hf.batch_decode(enc["input_ids"], skip_special_tokens=skip)


# -- the chat template -----------------------------------------------------

MESSAGES = [
    [{"role": "system", "content": "  Be brief.  "},
     {"role": "user", "content": "Rewrite: ✓ water bottle\n"}],
    [{"role": "user", "content": "one"}, {"role": "assistant",
                                          "content": ""},
     {"role": "user", "content": "two"}],
]


@pytest.mark.parametrize("template", ["jax_test", "llama3_style"])
def test_chat_template_matches_apply_chat_template(template):
    import jinja2
    from transformers import PreTrainedTokenizerFast

    from garbage_classification_rca_tpu_torch.data.chat_template import (
        render_chat)
    from garbage_classification_rca_tpu_torch.data.tokenizer import (
        HFTokenizer)

    lib, spec, eos = _tokenizers("llama3")
    source = (CHAT_TEMPLATE if template == "jax_test"
              else chip_smoke.LLAMA3_STYLE_TEMPLATE)
    hf = PreTrainedTokenizerFast(tokenizer_object=lib, eos_token=eos,
                                 bos_token="<|begin_of_text|>")
    hf.chat_template = source
    ours = HFTokenizer(spec, {"eos_token": eos,
                              "bos_token": "<|begin_of_text|>"})
    for messages in MESSAGES:
        for gen in (True, False):
            want = hf.apply_chat_template(messages, tokenize=False,
                                          add_generation_prompt=gen)
            got = render_chat(source, messages, add_generation_prompt=gen,
                              special_tokens=ours.special_tokens())
            assert got == want
    if template == "llama3_style":
        bad = [{"role": "system", "content": "s"},
               {"role": "tool", "content": "t"}]
        with pytest.raises(jinja2.exceptions.TemplateError,
                           match="only user and assistant"):
            hf.apply_chat_template(bad, tokenize=False)
        with pytest.raises(jinja2.exceptions.TemplateError,
                           match="only user and assistant"):
            render_chat(source, bad, special_tokens=ours.special_tokens())


# -- the Llama -------------------------------------------------------------

def _hf_llama(cfg):
    from transformers import LlamaForCausalLM

    model = LlamaForCausalLM(cfg).eval()
    with torch.no_grad():           # norms away from 1, as trained
        for name, p in model.named_parameters():
            if "norm" in name:
                p.uniform_(0.5, 1.5)
    return model


LLAMAS = {
    "gqa_4_2_llama3": dict(num_key_value_heads=2, rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 16},
        rope_theta=500000.0, tie_word_embeddings=False),
    "mha_tied": dict(num_key_value_heads=4, tie_word_embeddings=True),
    "gqa_4_1_untied": dict(num_key_value_heads=1, rope_theta=10000.0,
                           tie_word_embeddings=False, head_dim=16),
}


@pytest.mark.parametrize("name", sorted(LLAMAS))
def test_llama_logits_match_transformers(name):
    from transformers import LlamaConfig

    from garbage_classification_rca_tpu_torch.models.text import llama

    torch.manual_seed(1)
    hcfg = LlamaConfig(vocab_size=320, hidden_size=64, intermediate_size=96,
                       num_hidden_layers=2, num_attention_heads=4,
                       max_position_embeddings=256, rms_norm_eps=1e-5,
                       **LLAMAS[name])
    hf = _hf_llama(hcfg)
    cfg = llama.LlamaConfig.from_hf(hcfg.to_dict())
    assert cfg.params() == sum(p.numel() for p in hf.parameters())
    model = llama.LlamaForCausalLM.from_hf_state_dict(
        cfg, hf.state_dict(), "cpu")
    rng = np.random.default_rng(2)
    lens = [40, 23, 1, 40]
    ids = torch.from_numpy(rng.integers(0, 320, (4, 40)))
    mask = torch.zeros(4, 40, dtype=torch.long)
    for i, n in enumerate(lens):
        mask[i, 40 - n:] = 1
        ids[i, :40 - n] = 7
    pos = llama.LlamaForCausalLM.positions(mask)
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask,
                  position_ids=pos).logits
        got = model(ids, mask)
        real = mask.bool()
        scale = want[real].abs().max()
        assert float((got[real] - want[real]).abs().max() / scale) <= 1e-5
        # the cached path: prefill, then 3 decode steps, against the
        # forward over the longer sequence
        new = torch.from_numpy(rng.integers(0, 320, (4, 3)))
        last, cache = model.prefill(ids, mask, 3)
        steps = [last]
        for t in range(2):
            steps.append(model.decode_step(new[:, t], cache))
        full = model(torch.cat([ids, new], 1),
                     torch.cat([mask, torch.ones(4, 3, dtype=torch.long)],
                               1))
        for t, s in enumerate(steps):
            assert float((s - full[:, 39 + t]).abs().max() / scale) <= 1e-5


# -- the paraphraser -------------------------------------------------------

def _write_tokenizer(path, kind, template=None):
    """The tokenizer files of `kind` into `path`, as transformers saves
    them (``AutoTokenizer.from_pretrained`` reads them)."""
    lib, spec, eos = _tokenizers(kind)
    with open(os.path.join(path, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    cfg = {"eos_token": eos, "tokenizer_class": "PreTrainedTokenizerFast",
           "model_input_names": ["input_ids", "attention_mask"],
           "clean_up_tokenization_spaces": kind == "llama3",
           "chat_template": template or (
               chip_smoke.LLAMA3_STYLE_TEMPLATE if kind == "llama3"
               else CHAT_TEMPLATE)}
    if kind == "llama3":
        cfg["bos_token"] = "<|begin_of_text|>"
    with open(os.path.join(path, "tokenizer_config.json"), "w",
              encoding="utf-8") as f:
        json.dump(cfg, f, ensure_ascii=False)
    return spec


@pytest.fixture(scope="module", params=["llama3", "gpt2"])
def llm_dir(request, tmp_path_factory):
    """A tiny random Llama saved by transformers (GQA 4 / 2, llama3
    scaling, fp32) with a tokenizer of each form."""
    from transformers import LlamaConfig

    kind = request.param
    path = tmp_path_factory.mktemp(f"llama_{kind}")
    spec = _write_tokenizer(path, kind)
    vocab = len(spec["model"]["vocab"]) + len(spec["added_tokens"])
    torch.manual_seed(3)
    hf = _hf_llama(LlamaConfig(
        vocab_size=vocab + 5, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=1024, rope_theta=500000.0,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 64}))
    with torch.no_grad():           # peaked enough that eos gets drawn
        hf.lm_head.weight.mul_(8.0)
    hf.save_pretrained(path)
    return str(path)


SENTENCES = ['"water bottle"', "banana peel ", "old battery pack",
             "coffee cup", "tin can", "yard waste", "paint can",
             "greasy pizza box", "apple core", "newspaper"]


def test_make_hf_llm_fn_matches_jax(llm_dir):
    from garbage_classification_rca_tpu.data import synonymize as jsyn
    from garbage_classification_rca_tpu_torch.data import synonymize as tsyn

    for batch_size, seed in ((8, 5), (3, 6)):
        jfn = jsyn.make_hf_llm_fn(llm_dir, batch_size=batch_size)
        tfn = tsyn.make_hf_llm_fn(llm_dir, batch_size=batch_size, seed=seed,
                                  device="cpu")
        torch.manual_seed(seed)
        want = jfn(SENTENCES)
        got = tfn(SENTENCES)
        assert got == want
        assert all(isinstance(s, str) and "\n" not in s for s in got)
    # single strings draw on, from the same streams
    torch.manual_seed(9)
    jfn = jsyn.make_hf_llm_fn(llm_dir)
    tfn = tsyn.make_hf_llm_fn(llm_dir, seed=9, device="cpu")
    assert [tfn(s) for s in SENTENCES[:3]] == [jfn(s) for s in SENTENCES[:3]]


def test_warped_distributions_match_generate(llm_dir):
    """Each step's warped scores (temperature 0.4, top-k 50 from
    GenerationConfig's default, top-p 0.9) as probabilities within 1e-6
    of transformers' ``generate(output_scores=True)``, and the same
    sequences from one seed."""
    from transformers import AutoModelForCausalLM, AutoTokenizer

    from garbage_classification_rca_tpu_torch.data import synonymize as tsyn
    from garbage_classification_rca_tpu_torch.models.text import llama
    from garbage_classification_rca_tpu_torch.ops.sampling import (
        warp_logits_hf)

    hf_tok = AutoTokenizer.from_pretrained(llm_dir, padding_side="left")
    hf_tok.pad_token = hf_tok.eos_token
    hf = AutoModelForCausalLM.from_pretrained(llm_dir).eval()
    model, tok, gen_cfg = tsyn.load_llm(llm_dir, "cpu")
    texts, _ = tsyn.chats(tok, SENTENCES[:5])
    assert texts == [hf_tok.apply_chat_template(
        [{"role": "system", "content": tsyn.system_prompt()},
         {"role": "user", "content": tsyn.user_prompt(s)}], tokenize=False,
        add_generation_prompt=True) for s in SENTENCES[:5]]
    enc = hf_tok(texts, return_tensors="pt", add_special_tokens=False,
                 padding=True)
    ids, mask = tok.batch(texts)
    assert ids.tolist() == enc["input_ids"].tolist()
    torch.manual_seed(4)
    with torch.no_grad():
        out = hf.generate(**enc, max_new_tokens=6, do_sample=True,
                          temperature=0.4, top_p=0.9,
                          eos_token_id=hf_tok.eos_token_id,
                          pad_token_id=hf_tok.eos_token_id,
                          output_scores=True, return_dict_in_generate=True)
    scores, g = [], torch.Generator().manual_seed(4)

    def warp(logits):
        scores.append(warp_logits_hf(logits, 0.4, gen_cfg.get("top_k", 50),
                                     0.9))
        return scores[-1]

    with torch.no_grad():
        got = llama.generate(
            model, torch.from_numpy(ids), torch.from_numpy(mask),
            max_new_tokens=6, eos_id=tok.eos_token_id,
            pad_id=tok.eos_token_id, generator=g, warp=warp)
    assert torch.equal(got, out.sequences)
    assert len(scores) == len(out.scores) >= 1
    for ours, theirs in zip(scores, out.scores):
        assert torch.equal(torch.isinf(ours), torch.isinf(theirs))
        d = (torch.softmax(ours, -1) - torch.softmax(theirs, -1)).abs()
        assert float(d.max()) <= 1e-6


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.4, 50, 0.9), (1.0, 0, 0.75), (0.7, 3, 1.0), (0.4, 400, 0.5)])
def test_warp_logits_hf_matches_transformers_warpers(temperature, top_k,
                                                     top_p):
    """``warp_logits_hf`` against transformers' own warpers, in generate's
    order, on random rows and on rows of exact ties (four equal logits:
    cumulative masses 0.25, 0.5, 0.75, 1 hit ``1 - top_p`` exactly)."""
    from transformers.generation.logits_process import (
        LogitsProcessorList, TemperatureLogitsWarper, TopKLogitsWarper,
        TopPLogitsWarper)

    from garbage_classification_rca_tpu_torch.ops.sampling import (
        warp_logits_hf)

    warpers = LogitsProcessorList(
        ([TemperatureLogitsWarper(temperature)] if temperature != 1.0
         else []) + ([TopKLogitsWarper(top_k)] if top_k else [])
        + ([TopPLogitsWarper(top_p)] if top_p < 1.0 else []))
    g = torch.Generator().manual_seed(7)
    rows = torch.randn(6, 300, generator=g) * 4
    ties = torch.full((2, 300), -1e4)
    ties[:, :4] = 2.0
    scores = torch.cat([rows, ties])
    want = warpers(torch.zeros(8, 1, dtype=torch.long), scores.clone())
    got = warp_logits_hf(scores, temperature, top_k, top_p)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(got[~torch.isinf(got)], want[~torch.isinf(want)])


def test_hf_synonymizer_backend_contract(llm_dir):
    """``tests/test_llm_backends.py``'s contracts on the port's backend
    with the port's model and tokenizer injected: a list in, a list of
    single-line strings out with the prompt stripped; one string in, one
    out, through ``Synonymizer``; every batch size gives every answer."""
    from garbage_classification_rca_tpu_torch.data import synonymize as tsyn

    model, tok, _ = tsyn.load_llm(llm_dir, "cpu")
    fn = tsyn.make_hf_llm_fn(model=model, tokenizer=tok, batch_size=2)
    out = fn(["water bottle", "banana peel", "old battery pack"])
    assert isinstance(out, list) and len(out) == 3
    for o in out:
        assert isinstance(o, str) and "\n" not in o
        assert "<|user|>" not in o and "Rewrite by swapping" not in o
    syn = tsyn.Synonymizer(llm_fn=fn)
    assert isinstance(syn.augment("tin can"), str)
    fn1 = tsyn.make_hf_llm_fn(model=model, tokenizer=tok, batch_size=1)
    assert len(fn1(["a b", "c d", "e f", "g h", "i j"])) == 5
