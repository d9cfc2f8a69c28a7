"""Text synonym augmentation (host-side, train-only).

The port's own copy of the JAX package's ``data/synonymize.py``: swap up to
3 words of the short garbage description with synonyms from a curated
domain table, with a deterministic RNG, gated per batch at
``--prob_aug_text`` by the text trainer. The reference paraphrases with
Llama-3.1-8B-Instruct: ``make_hf_llm_fn`` is that backend
(``GC_RCA_LLM_PATH``), on the port's own Llama (``models/text/llama``),
tokenizer.json reader (``data/tokenizer.HFTokenizer``), chat-template
renderer (``data/chat_template``) and safetensors reader
(``checkpoint/hf_dir``): the card's machine has no transformers.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

# compact domain table for the Calgary garbage-text vocabulary
SYNONYMS = {
    "bottle": ["flask", "container", "vial"],
    "can": ["tin", "canister"],
    "cup": ["mug", "beaker"],
    "box": ["carton", "crate", "case"],
    "bag": ["sack", "pouch"],
    "paper": ["sheet", "page"],
    "newspaper": ["paper", "gazette"],
    "plastic": ["polymer"],
    "glass": ["crystal"],
    "metal": ["steel", "alloy"],
    "food": ["meal", "leftovers"],
    "peel": ["skin", "rind"],
    "battery": ["cell", "powercell"],
    "phone": ["handset", "mobile"],
    "old": ["used", "worn"],
    "broken": ["damaged", "cracked"],
    "empty": ["hollow", "drained"],
    "small": ["little", "tiny"],
    "large": ["big", "huge"],
    "water": ["drinking"],
    "coffee": ["espresso"],
    "waste": ["trash", "refuse"],
    "container": ["receptacle", "holder"],
    "wrapper": ["wrapping", "foil"],
    "jar": ["pot", "vessel"],
    "lid": ["cap", "cover"],
    "toy": ["plaything"],
    "clothes": ["garments", "apparel"],
    "shoe": ["sneaker", "boot"],
}

MAX_SWAPS = 3  # reference contract: swap <= 3 words


class Synonymizer:
    def __init__(self, seed: int = 0,
                 llm_fn: Optional[Callable[[str], str]] = None):
        self.rng = np.random.default_rng(seed)
        self.llm_fn = llm_fn

    def augment(self, text: str) -> str:
        if self.llm_fn is not None:
            return self.llm_fn(text)
        words = text.split()
        swappable = [i for i, w in enumerate(words) if w.lower() in SYNONYMS]
        if not swappable:
            return text
        self.rng.shuffle(swappable)
        for i in swappable[:MAX_SWAPS]:
            options = SYNONYMS[words[i].lower()]
            words[i] = options[int(self.rng.integers(len(options)))]
        return " ".join(words)


# reference synonymizer.py:59-64 and :74-78, verbatim
def system_prompt(max_changes: int = MAX_SWAPS) -> str:
    return (
        "You are a careful paraphraser. Your task is to replace a FEW words "
        "with close synonyms while preserving exact meaning, tone, and "
        "grammar. "
        "Do NOT alter numbers, units, dates, or named entities. "
        f"Change at most {max_changes} words. Output ONLY the final "
        "sentence."
    )


def user_prompt(text: str, max_changes: int = MAX_SWAPS) -> str:
    return (f"Rewrite by swapping a few words with close synonyms "
            f"(at most {max_changes}).\n"
            f"Sentence: {text}")


# the JAX package's decode-strip: the tags an answer may start with
ANSWER_TAGS = ["Assistant:", "assistant:", "Response:", "Output:",
               "assistant"]


def chats(tokenizer, sentences, max_changes: int = MAX_SWAPS):
    """The rendered chat of each sentence (its user prompt beside it)."""
    from .chat_template import render_chat

    ups = [user_prompt(t, max_changes) for t in sentences]
    return [render_chat(tokenizer.chat_template,
                        [{"role": "system",
                          "content": system_prompt(max_changes)},
                         {"role": "user", "content": up}],
                        add_generation_prompt=True,
                        special_tokens=tokenizer.special_tokens())
            for up in ups], ups


def load_llm(model_path: str, device):
    """(model fp32 on `device`, tokenizer, generation config) of a local
    transformers Llama directory; a missing directory raises."""
    from ..checkpoint.hf_dir import read_model_dir
    from ..models.text.llama import LlamaConfig, LlamaForCausalLM
    from .tokenizer import HFTokenizer

    config, gen_config, sd = read_model_dir(model_path)
    model = LlamaForCausalLM.from_hf_state_dict(
        LlamaConfig.from_hf(config), sd, device)
    return model, HFTokenizer.from_dir(model_path), gen_config


def make_hf_llm_fn(model_path: str = None, *, model=None, tokenizer=None,
                   max_changes: int = MAX_SWAPS, temperature: float = 0.4,
                   top_p: float = 0.9, max_new_tokens: int = 6,
                   batch_size: int = 8, seed: int = 0, device=None):
    """The reference LLM paraphraser backend, template-exact
    (synonymizer/synonymizer.py:42-126), as the JAX package runs it through
    transformers: the model's chat template over the reference's system
    and user prompts, left-padded batches of `batch_size`, transformers'
    sampling (temperature 0.4, top-k from ``generation_config.json``, 50
    without one, top-p 0.9; 6 new tokens; eos and pad the tokenizer's eos),
    the decode-strip on the rendered user prompt, the tags and the
    whitespace.

    ``model_path``: a local transformers Llama directory, read with the
    port's own readers onto `device` (default the CLIs' device: the card
    unless ``GC_RCA_PLATFORM=cpu``), in fp32 as ``from_pretrained`` loads
    it; or inject ``model`` (a ``models.text.llama.LlamaForCausalLM``) and
    ``tokenizer`` (a ``data.tokenizer.HFTokenizer``). The draws come from a
    ``torch.Generator`` on the model's device seeded with `seed` (the JAX
    package draws from torch's global generator). Returns ``fn(sentence
    or list) -> str or list``, which plugs into ``Synonymizer(llm_fn=)``."""
    import torch

    from ..models.text.llama import generate
    from ..ops.sampling import warp_logits_hf

    gen_config = {}
    if model is None or tokenizer is None:
        if device is None:
            from ..cli import cli_device
            from ..device import resolve_device

            device = resolve_device(cli_device())
        model, tokenizer, gen_config = load_llm(model_path, device)
    top_k = gen_config.get("top_k", 50)
    dev = model.inv_freq.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def warp(logits):
        return warp_logits_hf(logits, temperature, top_k, top_p)

    def llm_fn(sentences):
        single = isinstance(sentences, str)
        if single:
            sentences = [sentences]
        cleaned = [s.strip().strip('"').strip("'") for s in sentences]
        outputs = []
        for start in range(0, len(cleaned), batch_size):
            texts, ups = chats(tokenizer, cleaned[start:start + batch_size],
                               max_changes)
            ids, mask = tokenizer.batch(texts)
            with torch.no_grad():
                gen = generate(
                    model, torch.from_numpy(ids).to(dev),
                    torch.from_numpy(mask).to(dev),
                    max_new_tokens=max_new_tokens, warp=warp,
                    eos_id=tokenizer.eos_token_id,
                    pad_id=tokenizer.eos_token_id, generator=g)
            decoded = tokenizer.batch_decode(gen.cpu().tolist(),
                                             skip_special_tokens=True)
            for text_out, up in zip(decoded, ups):
                out = text_out.split(up)[-1].strip()
                for tag in ANSWER_TAGS:
                    if out.startswith(tag):
                        out = out[len(tag):].strip()
                outputs.append(" ".join(out.split()))
        return outputs[0] if single else outputs

    return llm_fn
