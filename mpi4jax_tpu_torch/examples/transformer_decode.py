"""Greedy-decode throughput of the transformer, on PyTorch.

The counterpart of ``benchmarks/transformer.py:run_decode``: generated
tokens per second through ``make_global_decode`` on one rank, with the
same JSON record (the bytes model of a generated step included).  The
model defaults are the decode benchmark's (vocab 32768, d_model 512, 8
layers, 8 heads of 64, d_ff 2048); weights and prompts are random, made
from a fixed seed.

Usage:

    # the long-prompt serving point: batch 4, prompt 8192, 256 generated
    # tokens, bf16, flash prefill (the hand-written CUDA kernel),
    # kv_bucket 16
    python -m mpi4jax_tpu_torch.examples.transformer_decode --long

    # run_decode's defaults: batch 8, prompt 16, max_len 512, f32
    python -m mpi4jax_tpu_torch.examples.transformer_decode

    # the plain PyTorch path on the CPU, small
    python -m mpi4jax_tpu_torch.examples.transformer_decode --device cpu \\
        --batch 2 --prompt 8 --max-len 24 --batches 1

Timing follows run_decode: one warm-up decode, then the minimum over
``--batches`` bursts of 2 decodes, each burst ended by a device
synchronize.  The rate counts generated tokens over the whole decode
wall time, prefill included.
"""

import argparse
import json
import time

import torch

LONG = dict(batch=4, prompt=8192, max_len=8448, kv_bucket=16, bf16=True,
            prefill_impl="flash")


def decode_bytes_per_step(cfg, params, batch, prompt, max_len):
    """``run_decode``'s bytes model of one generated step: every weight
    read once but the embedding table (decode gathers ``batch`` rows of
    it), the KV cache read at the average length over the generation,
    one position written."""
    leaves = [params.embed, *params.blocks, params.ln_f, params.head]
    params_bytes = sum(t.numel() * t.element_size() for t in leaves)
    embed_bytes = params.embed.numel() * params.embed.element_size()
    esz = params.embed.element_size()
    kv_per_pos = cfg.layers * batch * cfg.kv_heads * cfg.head_dim * 2 * esz
    avg_positions = (prompt + max_len) / 2
    per_step = (params_bytes - embed_bytes) + kv_per_pos * avg_positions \
        + kv_per_pos
    return per_step, params_bytes


def run_decode(batch=8, prompt=16, max_len=512, layers=8, d_model=512,
               heads=8, kv_heads=8, d_ff=2048, vocab=32768, bf16=False,
               batches=5, kv_bucket=None, prefill_impl="xla", device="cuda"):
    """Decode throughput record (``run_decode``'s keys, and the device
    it ran on)."""
    from mpi4jax_tpu_torch.models import transformer as tfm
    from mpi4jax_tpu_torch.parallel.comm import MeshComm
    from mpi4jax_tpu_torch.utils.runtime import drain, resolve_device

    device = resolve_device(device)
    world = MeshComm(axes=("dp", "tp"), axis_sizes=(1, 1))
    dp, tp = world.sub("dp"), world.sub("tp")
    dtype = torch.bfloat16 if bf16 else torch.float32
    cfg = tfm.TransformerConfig(
        vocab=vocab, d_model=d_model, layers=layers, heads=heads,
        kv_heads=kv_heads, head_dim=d_model // heads, d_ff=d_ff,
    )
    gen = torch.Generator(device=device).manual_seed(0)
    params = tfm.init_params(cfg, generator=gen, dtype=dtype, device=device)
    decode = tfm.make_global_decode(
        dp, tp, cfg, max_len, kv_bucket=kv_bucket, prefill_impl=prefill_impl,
        device=device,
    )
    prompts = torch.randint(0, vocab, (batch, prompt), generator=gen,
                            device=device, dtype=torch.int32)

    out = decode(params, prompts)  # warm-up
    drain(out)
    walls = []
    for _ in range(batches):
        t0 = time.perf_counter()
        out = decode(params, prompts)
        out = decode(params, prompts)
        drain(out)
        walls.append((time.perf_counter() - t0) / 2.0)
    best = min(walls)
    generated = batch * (max_len - prompt)
    bytes_per_step, params_bytes = decode_bytes_per_step(
        cfg, params, batch, prompt, max_len
    )
    return {
        "metric": "transformer_decode_tokens_per_sec",
        "value": generated / best,
        "unit": "generated tokens/s",
        "devices": 1,
        "mesh": [1, 1],
        "dtype": "bf16" if bf16 else "f32",
        "batch": batch,
        "prompt": prompt,
        "max_len": max_len,
        "wall_s": best,
        "tokens_per_sec_per_seq": (max_len - prompt) / best,
        "hbm_bytes_per_step": int(bytes_per_step),
        "params_bytes": int(params_bytes),
        **({"kv_bucket": kv_bucket} if kv_bucket else {}),
        **({"prefill_impl": prefill_impl} if prefill_impl != "xla" else {}),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--long", action="store_true",
                   help="batch 4, prompt 8192, max_len 8448, kv_bucket 16, "
                   "bf16, flash prefill")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt", type=int, default=16)
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--kv-bucket", type=int, default=None)
    p.add_argument("--prefill-impl", choices=("xla", "flash"), default="xla")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--batches", type=int, default=5)
    p.add_argument(
        "--device", default="cuda",
        help="'cuda' (default; the hand-written kernel) or 'cpu' (its "
        "plain PyTorch version)",
    )
    args = p.parse_args(argv)
    kw = dict(batch=args.batch, prompt=args.prompt, max_len=args.max_len,
              kv_bucket=args.kv_bucket, bf16=args.bf16,
              prefill_impl=args.prefill_impl)
    if args.long:
        kw.update(LONG)
    rec = run_decode(**kw, batches=args.batches, device=args.device)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
