"""Continuous-batching generation server CLI (JSONL stdin -> stdout).

``python -m garbage_classification_rca_tpu_torch.cli.serve
  --model_path=<HF Blip2ForConditionalGeneration .pth, plain or
  peft-wrapped; or a BEST file of cli.blip2_train> --vocab_dir=...
  [--max_new_tokens=16] [--serve_slots=8] [--max_prompt=100]
  [--steps_per_sync=8] [--kv_cache_dtype=int8] [--int8_weights]
  [--gen_temperature=T --gen_top_k=K --gen_top_p=P --gen_seed=S]``

The port of the JAX package's ``cli/serve.py``, the same protocol, one
JSON object a line:

  request : {"id": <any json>, "text": "<prompt>",
             "image": "/path.jpg" (optional: a BLIP-2 visual prompt),
             "max_new": <int> (optional budget of this request)}
  response: {"id": ..., "text": "<decoded>", "tokens": [...],
             "n_tokens": N}, one line a request as it finishes
             (completion order), the fed EOS stripped

A reader thread feeds the scheduler, so running slots keep decoding while
the host waits on stdin. A line that does not parse to an object is
reported on stderr; a request with a bad field gets an
``{"id": ..., "error": ...}`` line; neither stops the server. Image
prompts are the BLIP-2 assembly (``blip2.prompt_embeds``: the projected
query embeddings, then the text left-padded to ``max_prompt - n_query``),
embedded a batch of ``--serve_slots`` at a time; text prompts are OPT's
token embeddings of the text left-padded to ``--max_prompt``, at batch 1.
Sampled requests draw from ``Key(--gen_seed).fold_in(uid)``, uids in
arrival order.

Runs on CUDA; ``GC_RCA_PLATFORM=cpu`` runs it on the CPU and
``GC_RCA_TINY_BLIP2=1`` swaps in the tiny geometry. ``--mesh_shape=
model:M`` (or ``data:1,model:M``) runs the JAX CLI's tensor-parallel tower
over M processes (``torchrun --nproc_per_node=M``; ``parallel/tp.py``):
rank 0 reads stdin, embeds the requests (the vision tower runs there) and
writes stdout; each round it broadcasts what it admitted (the count, end
of input, and each request's budget, mask and prompt embeddings) so that
every rank submits the same requests in the same order and runs the same
schedule, the same refills, lanes and steps, and draws the same tokens. A
rank other than 0 waits in that broadcast while rank 0 waits on stdin,
for at most ``GC_RCA_DIST_TIMEOUT`` seconds. A data axis of more than one
rank is refused (the JAX server only replicates there), as are
``GC_RCA_MULTIHOST`` runs and orbax adapter directories.
"""

from __future__ import annotations

import json
import os
import queue
import sys
import threading

import numpy as np
import torch

_EOF = object()  # the reader's end of stream (a JSON null must not be it)


def _build_embedders(cfg, model, args, tok, compute_dtype):
    """-> embed_requests([req, ...], pixs) -> [(embeds [L, H] on the
    device, mask [L] int32 numpy), ...] in the same order. pixs[i]: the
    preprocessed uint8 [224, 224, 3] image of request i, or None."""
    from ..models.vlm import blip2
    from ..models.vlm import opt as opt_mod
    from .blip2_common import left_pad, normalize_clip

    n_query = cfg.qformer.n_query
    # image requests are refused upstream when max_prompt <= n_query
    t_len_img = max(args.max_prompt - n_query, 1)
    emb = model.opt.embed_tokens.w
    g = max(args.serve_slots, 1)            # the vision tower's batch

    def _tokenize(req, t_len):
        pids, _ = tok.encode_one(req.get("text", ""), t_len)
        return left_pad(pids, t_len, tok.pad_id)

    def _ids(rows):
        return torch.tensor(rows, dtype=torch.int32, device=emb.device)

    @torch.no_grad()
    def embed_requests(reqs, pixs):
        out = [None] * len(reqs)
        img_idx = [i for i in range(len(reqs)) if pixs[i] is not None]
        for base in range(0, len(img_idx), g):
            grp = img_idx[base:base + g]
            rows = grp + [grp[0]] * (g - len(grp))
            pix = torch.from_numpy(np.stack([pixs[i] for i in rows])).to(
                emb.device)
            toks_masks = [_tokenize(reqs[i], t_len_img) for i in rows]
            e, m = blip2.prompt_embeds(
                model, normalize_clip(pix, compute_dtype),
                _ids([t[0] for t in toks_masks]),
                _ids([t[1] for t in toks_masks]))
            e, m = e.to(emb.dtype), m.cpu().numpy().astype(np.int32)
            for j, i in enumerate(grp):
                out[i] = (e[j], m[j])
        for i, r in enumerate(reqs):
            if out[i] is None:
                ids, mask = _tokenize(r, args.max_prompt)
                e = opt_mod.embed_tokens(model.opt, _ids([ids]))
                out[i] = (e[0].to(emb.dtype), np.asarray(mask, np.int32))
        return out

    return embed_requests


def _share_round(mesh, eof, admitted, max_prompt, hidden, dtype, device):
    """Rank 0's round on every rank: (eof, [(embeds [max_prompt, H] in
    `dtype`, mask [max_prompt] int32 numpy, budget), ...]); `eof` and
    `admitted` are read on rank 0 only. The tensors travel as bytes."""
    from ..parallel.multihost import broadcast_

    group = mesh.group("model")
    head = torch.tensor([len(admitted), int(eof)], dtype=torch.int64,
                        device=device)
    broadcast_(head, group)
    n, eof = int(head[0]), bool(head[1])
    if n == 0:
        return eof, []
    if mesh.is_primary:
        emb = torch.stack([torch.nn.functional.pad(
            e.to(device, dtype), (0, 0, 0, max_prompt - e.shape[0]))
            for e, _, _ in admitted])
        rest = torch.tensor(np.stack([np.concatenate(
            [np.pad(m, (0, max_prompt - len(m))), [b]])
            for _, m, b in admitted]).astype(np.int64), device=device)
    else:
        emb = torch.empty((n, max_prompt, hidden), dtype=dtype,
                          device=device)
        rest = torch.empty((n, max_prompt + 1), dtype=torch.int64,
                           device=device)
    broadcast_(emb.view(torch.uint8), group)
    broadcast_(rest, group)
    rest = rest.cpu().numpy()
    return eof, [(emb[i], rest[i, :-1].astype(np.int32), int(rest[i, -1]))
                 for i in range(n)]


def _reader(stream, q):
    """stdin thread: request dicts -> q, then _EOF. A line that does not
    parse, or parses to a non-object (no "id" to echo), is reported on
    stderr and skipped."""
    for line in stream:
        line = line.strip()
        if not line:
            continue
        try:
            item = json.loads(line)
        except json.JSONDecodeError as e:
            print(json.dumps({"error": f"bad request line: {e}"}),
                  file=sys.stderr, flush=True)
            continue
        if not isinstance(item, dict):
            print(json.dumps({"error": "bad request line: expected a JSON "
                              f"object, got {type(item).__name__}"}),
                  file=sys.stderr, flush=True)
            continue
        q.put(item)
    q.put(_EOF)


def _validate_request(item, img_ok, n_query):
    """A field error -> the message of an {"id":..., "error":...} line;
    None when the request is well formed."""
    txt = item.get("text", "")
    if not isinstance(txt, str):
        return f"'text' must be a string, got {type(txt).__name__}"
    img = item.get("image")
    if img is not None and not isinstance(img, str):
        return f"'image' must be a path string, got {type(img).__name__}"
    mn = item.get("max_new", 1)
    if isinstance(mn, bool) or not isinstance(mn, int) or mn < 1:
        return f"'max_new' must be a positive integer, got {mn!r}"
    if img and not img_ok:
        return (f"image prompts need --max_prompt > n_query={n_query} "
                "(the projected query embeddings leave no room for text)")
    return None


def main(argv=None, stdin=None, stdout=None):
    from ..config import args_parser, torch_compute_dtype
    from ..data.images import blip_preprocess_image
    from ..nn.core import Key
    from ..parallel.mesh import DATA_AXIS
    from ..serving.engine import GenerationServer
    from . import check_eval_flags, data_mesh
    from .blip2_common import build_blip2, place_blip2, sampler_from_args

    args = args_parser(argv)
    check_eval_flags(args, allowed=("model",))
    if os.environ.get("GC_RCA_MULTIHOST"):
        raise SystemExit("multi-host (GC_RCA_MULTIHOST) is not supported by "
                         "the serve CLI; run its ranks on one host")
    mesh = data_mesh(args, allowed=("model",))
    if mesh.size(DATA_AXIS) > 1:
        raise NotImplementedError(
            f"--mesh_shape={args.mesh_shape}: cli.serve runs a model axis "
            "(data:1,model:M); over a data axis the JAX server only "
            "replicates the tower, which the port does not run")
    device = mesh.device
    tp = mesh.size("model") > 1
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    dtype = torch_compute_dtype(args.compute_dtype)
    cfg, model, tok = build_blip2(args, device, dtype)
    if args.int8_weights:
        from ..ops.quant import quantize_opt_weights

        quantize_opt_weights(model.opt)
    place_blip2(model, mesh)
    n_query = cfg.qformer.n_query
    img_ok = args.max_prompt > n_query
    if not img_ok:
        print(f"warning: --max_prompt={args.max_prompt} <= n_query="
              f"{n_query}; image requests will be rejected with error "
              "lines", file=sys.stderr, flush=True)
    sampler = sampler_from_args(args)
    max_new = max(args.max_new_tokens, 1)
    srv = GenerationServer(model.opt, slots=args.serve_slots,
                           max_prompt=args.max_prompt, max_new=max_new,
                           eos_id=2, lora=model.lora,
                           lora_scale=cfg.lora_scale, sampler=sampler,
                           rng=Key(args.gen_seed) if sampler else None,
                           cache_dtype=args.kv_cache_dtype or None,
                           steps_per_sync=args.steps_per_sync)
    embed_requests = _build_embedders(cfg, model, args, tok, dtype)

    q: queue.Queue = queue.Queue()
    if mesh.is_primary:
        threading.Thread(target=_reader, args=(stdin, q),
                         daemon=True).start()
    uid_to_id = {}
    eof = False

    def emit(finished):
        if not mesh.is_primary:
            return
        for r in finished:
            toks = list(r.tokens)
            if toks and toks[-1] == 2:          # strip the fed EOS
                toks = toks[:-1]
            out = {"id": uid_to_id.pop(r.uid), "text": tok.decode(toks),
                   "tokens": [int(x) for x in toks], "n_tokens": len(toks)}
            print(json.dumps(out), file=stdout, flush=True)

    while not eof or srv.has_work:
        # take every request already waiting; block only when idle
        pending, pixs = [], []
        while not eof and mesh.is_primary:
            try:
                item = q.get(block=not srv.has_work and not pending)
            except queue.Empty:
                break
            if item is _EOF:
                eof = True
                break
            err = _validate_request(item, img_ok, n_query)
            pix = None
            if err is None and item.get("image"):
                try:
                    pix = blip_preprocess_image(item["image"]).astype(
                        np.uint8)
                except (OSError, ValueError, TypeError) as exc:
                    err = f"{type(exc).__name__}: {exc}"
            if err is not None:
                print(json.dumps({"id": item.get("id"), "error": err}),
                      file=stdout, flush=True)
                continue
            pending.append(item)
            pixs.append(pix)
        admitted = [(e, m, min(int(item.get("max_new", max_new)), max_new))
                    for item, (e, m) in zip(
                        pending, embed_requests(pending, pixs))] \
            if pending else []
        if tp:
            eof, admitted = _share_round(
                mesh, eof, admitted, args.max_prompt, cfg.opt.hidden,
                model.opt.embed_tokens.w.dtype, device)
        # submitted in arrival order: the uid-derived sampling keys
        # follow the request log
        for i, (e, m, budget) in enumerate(admitted):
            uid = srv.submit(e, m, max_new=budget)
            if mesh.is_primary:
                uid_to_id[uid] = pending[i].get("id")
        emit(srv.step())
    emit(srv.drain())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
