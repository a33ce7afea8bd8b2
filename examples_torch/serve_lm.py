"""Serving example on the PyTorch port: batched prefill + autoregressive
decode with a KV cache (greedy sampling), on the MLA architecture whose
cache is the compressed latent (minicpm3 family, smoke size; the port of
``examples/serve_lm.py``).

    PYTHONPATH=src python examples_torch/serve_lm.py [--device cpu]

``--device`` defaults to ``cuda`` and raises without a GPU.
"""

import argparse
import time

import torch

from repro_torch.configs import get
from repro_torch.device import resolve_device
from repro_torch.models import params as P
from repro_torch.models.model import build_model
from repro_torch.training.steps import make_prefill_step, \
    make_serve_decode_step


def main(device="cuda", batch=4, prompt_len=24, gen_len=16, seed=0
         ) -> dict:
    dev = resolve_device(device)
    cfg = get("minicpm3-4b").smoke
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.load_params(P.init(model.spec, gen, device=dev)).params

    max_len = prompt_len + gen_len
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    cache = model.init_cache(batch, max_len, device=dev)
    prefill = make_prefill_step(model)
    decode = make_serve_decode_step(model)

    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = prefill(params, {"tokens": prompts}, cache)
        tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)[:, None]
        out = [tok]
        for t in range(gen_len - 1):
            logits, cache = decode(params, cache, tok.to(torch.int32),
                                   prompt_len + t)
            tok = torch.argmax(logits[:, 0, :cfg.vocab], dim=-1)[:, None]
            out.append(tok)
    gen_tokens = torch.cat(out, dim=1).tolist()    # waits for the device
    dt = time.perf_counter() - t0
    print(f"prefill {batch}x{prompt_len} + decode {gen_len} tokens "
          f"in {dt:.2f}s ({batch * gen_len / dt:.1f} tok/s)")
    for b in range(batch):
        print(f"  seq {b}: {gen_tokens[b]}")
    latent = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    print("\nMLA cache stores the compressed KV latent "
          f"({latent} dims/token vs {2 * cfg.n_heads * 8} for full KV at "
          "this scale).")
    return dict(tokens=gen_tokens, seconds=dt, cache_shape=tuple(cache.shape),
                latent_dims=latent)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
