"""Batched serving CLI of the port (same CLI as ``repro.launch.serve``,
plus ``--device``): prefill a batch of prompts, then decode N tokens
synchronously (greedy), in float32 as the reference forces.  ``--arch``
takes every config the port builds (``configs.list_archs()``, the
jamba-v0.1-52b hybrid and the seamless-m4t-large-v2 encoder-decoder among
them); use ``--smoke`` on the CPU.  An encoder-decoder model's encoder
reads ``--prompt-len`` random frames a prompt (``enc_embeds``, float32, from
the same seeded generator as the prompts), as the reference's CLI does.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --batch 4 --prompt-len 16 --gen 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch seamless-m4t-large-v2 --smoke --device cpu

A Mamba-2 or jamba prompt must be a multiple of the SSD chunk, or shorter
than it (the scan's own rule), and is refused before anything runs
otherwise.
"""
import argparse

from repro_torch.configs.base import list_archs


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import time

    import torch

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels.ssd_scan import chunk_len
    from repro_torch.models.model import (decode_step, init_params, pad_cache,
                                          prefill)

    dev = resolve_device(args.device)
    cfg = (smoke_config(args.arch) if args.smoke
           else get_config(args.arch)).with_(dtype="float32")
    B, S0 = args.batch, args.prompt_len
    if cfg.ssm is not None:
        try:
            chunk_len(S0, cfg.ssm.chunk)
        except ValueError as e:
            ap.error(f"--prompt-len: {e}")
    params = init_params(cfg, args.seed, device=dev)
    max_len = S0 + args.gen
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (B, S0), generator=gen, device=dev)
    batch = {"tokens": prompts}
    if cfg.enc_layers:      # the audio frontend stub's frames, one per prompt token
        batch["enc_embeds"] = torch.randn((B, S0, cfg.d_model), generator=gen, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    cache, logits = prefill(cfg, params, batch)
    cache = pad_cache(cfg, cache, S0, max_len)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    print(f"[serve] prefill {B}x{S0}: {t_prefill:.3f}s "
          f"({B * S0 / t_prefill:.0f} tok/s)")

    toks = logits.argmax(-1, keepdim=True)
    out = [toks]
    t0 = time.perf_counter()
    for t in range(S0, max_len - 1):
        logits, cache = decode_step(cfg, params, cache, toks, t)
        toks = logits.argmax(-1, keepdim=True)
        out.append(toks)
    _sync(dev)
    t_dec = time.perf_counter() - t0
    n = len(out) - 1
    print(f"[serve] decoded {n} steps x {B} seqs: {t_dec:.3f}s "
          f"({B * n / max(t_dec, 1e-9):.0f} tok/s)")
    generated = torch.cat(out, dim=1)
    print("[serve] sample generations (token ids):")
    for b in range(min(B, 4)):
        print("  ", generated[b, :12].tolist())


if __name__ == "__main__":
    main()
