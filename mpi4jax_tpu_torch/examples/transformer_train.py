"""Training-step throughput of the transformer, on PyTorch.

The counterpart of ``benchmarks/transformer.py:run`` in its dense, moe
and pp modes: tokens per second through ``make_global_train_step`` (of
``models/transformer.py``, with ``--mode moe`` of
``models/moe_transformer.py``: 4 experts a sp rank, or with ``--mode
pp`` of ``models/pp_transformer.py``: GPipe over ``min(n, 4)`` stages)
on one rank, or on the mesh that run builds from the rank count
(:func:`train_mesh_shape`; pp: :func:`pp_mesh_shape`) when ``run`` is
given the world's comm (as the bench passes it under ``torchrun``),
with the same JSON record
(model FLOPs as 6·N·tokens, with and without the causal attention
scores, and the MFU of both against the cards' bf16 tensor-core
peak).  The presets are the benchmark's ``SIZES``, remat policy
included; weights and tokens are random, made from a fixed seed.

Usage:

    # the long-context preset: ~940M parameters (vocab 32768, d_model
    # 2048, 16 layers, 16 heads of 128, d_ff 8192), batch 2, seq 8192,
    # bf16, remat="names", attention and its gradient through the
    # hand-written CUDA flash kernels
    python -m mpi4jax_tpu_torch.examples.transformer_train --size long --bf16

    # the MFU preset (batch 16, seq 2048, the same model, remat="names"),
    # its attention picked by timing flash against the dense path
    python -m mpi4jax_tpu_torch.examples.transformer_train --size large \
        --bf16 --attn-impl autotune

    # the MoE model at the bench's default width (vocab 32768, d_model
    # 512, 8 layers, 8 heads of 64, d_ff 2048, 4 experts), batch 8, seq
    # 1024, f32; under torchrun on four cards: (1, 2, 2), 8 experts
    python -m mpi4jax_tpu_torch.examples.transformer_train --mode moe
    torchrun --nproc-per-node 4 -m \\
        mpi4jax_tpu_torch.examples.transformer_train --mode moe

    # the dense model of that width as a GPipe pipeline: 4 microbatches
    # (--micro), one stage on one card; under torchrun on four cards
    # (dp, pp) = (1, 4), 2 layers a stage
    python -m mpi4jax_tpu_torch.examples.transformer_train --mode pp
    torchrun --nproc-per-node 4 -m \\
        mpi4jax_tpu_torch.examples.transformer_train --mode pp --micro 4

    # the plain PyTorch path on the CPU, small
    python -m mpi4jax_tpu_torch.examples.transformer_train --device cpu \\
        --batch 2 --seq 32 --layers 2 --d-model 32 --heads 4 --kv-heads 2 \\
        --d-ff 64 --vocab 64 --attn-impl flash --batches 1

``--remat`` recomputes each layer in the backward, ``--remat-policy``
picks the policy (``full``, ``dots``, ``names`` or ``save:TAG,...``) and
overrides the preset's.  ``--attn-impl autotune`` times the flash
kernels against the dense attention at the run's shape
(:func:`autotune_attn_impl`); a preset's own attention (``long``:
flash) wins over ``auto`` and ``autotune``.  Timing follows ``run``: one untimed step (it builds the kernels at first use),
one measured step that sizes the timed batches (at least 4 steps each,
about a second), then the best of ``--batches`` batches, each ended by a
device synchronize.  The loss must stay finite.
"""

import argparse
import contextlib
import inspect
import json
import math
import os
import sys
import time

import torch

from mpi4jax_tpu_torch.parallel.comm import MeshComm

# benchmarks/transformer.py SIZES
SIZES = {
    "small": dict(batch=8, seq=1024, layers=8, d_model=512, heads=8,
                  kv_heads=8, d_ff=2048),
    "large": dict(batch=16, seq=2048, layers=16, d_model=2048, heads=16,
                  kv_heads=16, d_ff=8192, remat="names"),
    "long": dict(batch=2, seq=8192, layers=16, d_model=2048, heads=16,
                 kv_heads=16, d_ff=8192, remat="names", attn_impl="flash"),
}

# dense bf16 tensor-core peak per card (NVIDIA's data sheet, SXM part),
# keyed by a substring of torch.cuda.get_device_name; unknown cards omit
# the MFU keys rather than guess
PEAK_BF16_TFLOPS = {"H100": 989.0}


def train_mesh_shape(n):
    """``benchmarks/transformer.py``'s training mesh ``(dp, tp, sp)`` for
    ``n`` ranks: ``(n//4, 2, 2)`` when 4 divides ``n``, ``(1, 2, 1)`` on
    two, else ``(1, 1, 1)``."""
    if n % 4 == 0:
        return (n // 4, 2, 2)
    if n == 2:
        return (1, 2, 1)
    return (1, 1, 1)


def pp_mesh_shape(n):
    """``benchmarks/transformer.py``'s pp mesh ``(dp, pp)`` for ``n``
    ranks: ``min(n, 4)`` stages (1 on one rank), the rest over dp."""
    pp_n = min(n, 4) if n > 1 else 1
    return (n // pp_n, pp_n)


def mesh_comm(comm, names, shape):
    """A comm over the ranks of ``comm``'s world on the mesh ``shape``
    with the axis ``names``: the one-rank mesh without a comm (or on one
    rank).  The mesh covers every rank, or this raises (the JAX bench
    leaves the ranks outside its mesh idle; here every rank runs)."""
    n = 1 if comm is None else comm.size
    if n == 1:
        return MeshComm(axes=names, axis_sizes=(1,) * len(names))
    if math.prod(shape) != n:
        raise ValueError(
            f"the {'x'.join(map(str, shape))} mesh covers "
            f"{math.prod(shape)} of the {n} ranks"
        )
    return comm.world.comm((names, shape))


def world_readings(comm, values, device):
    """Each rank's ``values`` (floats), gathered in rank order: a list of
    lists, the same on every rank."""
    if comm is None or comm.size == 1:
        return [list(values)]
    from mpi4jax_tpu_torch.ops.collectives import allgather

    rows, _ = allgather(torch.tensor(values, dtype=torch.float64,
                                     device=device), comm=comm)
    return rows.tolist()


def _peak_tflops(device):
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, peak in PEAK_BF16_TFLOPS.items():
        if key in name:
            return peak
    return None


def attention_flops(cfg, batch, seq):
    """``run``'s attention-score FLOPs per step: QK^T and AV, 4·b·h·s²·d
    per layer forward, 3x for forward and backward, halved for the
    causal mask."""
    return 3 * 4 * cfg.layers * batch * cfg.heads * seq * seq \
        * cfg.head_dim * 0.5


def autotune_attn_impl(batch=8, seq=2048, heads=16, head_dim=64, chain=4,
                       reps=3, device="cuda", comm=None):
    """Time the flash kernels against the dense attention (``"xla"``),
    forward and backward, at ``[batch, seq, heads, head_dim]`` bf16, and
    return the faster one's name (``benchmarks/transformer.py``'s).

    Each timed call chains ``chain`` gradients of the causal attention's
    ``sum(out²)``, each step's q moved by ``1e-9·dq``, and ends in a
    synchronise; the best of ``reps`` calls after a warm one.  The batch
    is clamped to 8, as there: the ratio does not depend on it and the
    dense leg's [T, T] scores grow with it.  On the CPU it returns
    ``"auto"`` (the JAX version's off-TPU answer) without timing.  On the
    card both legs run, and an error in either raises.  With ``comm``,
    every rank times both and the slowest rank's times decide, so the
    ranks agree."""
    from mpi4jax_tpu_torch.parallel.longseq import local_attention
    from mpi4jax_tpu_torch.utils.runtime import resolve_device, slowest

    device = resolve_device(device)
    if device.type != "cuda":
        return "auto"
    shape = (min(batch, 8), seq, heads, head_dim)
    k, v = (torch.ones(shape, dtype=torch.bfloat16, device=device,
                       requires_grad=True) for _ in range(2))
    timings = {}
    for impl in ("flash", "xla"):
        def call(impl=impl):
            q = torch.ones(shape, dtype=torch.bfloat16, device=device)
            for _ in range(chain):
                q.requires_grad_(True)
                out = local_attention(q, k, v, causal=True, impl=impl)
                dq, _, _ = torch.autograd.grad(
                    (out.float() ** 2).sum(), (q, k, v))
                q = (q + 1e-9 * dq).detach()
            torch.cuda.synchronize(device)

        call()  # builds the kernels, warms up
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            best = min(best, time.perf_counter() - t0)
        timings[impl] = best
    timings = dict(zip(timings, slowest(comm, list(timings.values()),
                                        device)))
    winner = min(timings, key=timings.get)
    print(f"[transformer-train] attn autotune at {list(shape)}: "
          f"{timings} -> {winner}", file=sys.stderr)
    return winner


def run(batch=8, seq=1024, layers=8, d_model=512, heads=8, kv_heads=8,
        d_ff=2048, vocab=32768, bf16=False, batches=8, mode="dense",
        remat=False, attn_impl="auto", ce_chunk=0, sequence="ring",
        micro=None, device="cuda", timed=None, comm=None):
    """Train-step throughput record (``run``'s keys, and the device it
    ran on).  ``remat``, ``ce_chunk`` and ``sequence`` are the training
    step's (see ``make_global_train_step``); the record names the first
    two as ``run``'s does, and the peak device memory on the card.  The
    dense step is made with ``donate=True`` (the parameters updated in
    place, as the JAX bench donates them), so the peak memory holds one
    copy of them.

    ``mode="moe"`` times the MoE model (``models/moe_transformer.py``)
    of the same width with ``4 · sp`` experts, as the JAX bench's moe
    mode: its step as that mode makes it (no remat, the attention
    ``"auto"``, which takes the flash kernels on the card; ``remat`` and
    ``attn_impl`` are not used, and the record has no ``remat`` key),
    ``ce_chunk`` refused, the metric
    ``transformer_moe_train_tokens_per_sec``, and the model FLOPs from
    the active parameters (each token meets one expert's FFN of the
    ``E``: ``n − expert + expert / E``).

    ``mode="pp"`` times the dense model as a pipeline
    (``models/pp_transformer.py``) as the JAX bench's pp mode: the mesh
    ``(dp, pp)`` of :func:`pp_mesh_shape`, ``layers`` rounded down to a
    multiple of the stages, one a stage at least (a line on stderr says
    so), ``micro``
    microbatches (``min(4, batch)`` by default; ``batch`` must divide
    by it), the GPipe schedule, ``batch`` rows per dp rank and ``seq``
    whole on every stage; the stages' attention is the dense ``"xla"``
    path (no flash kernel), ``remat``, ``attn_impl``, ``ce_chunk`` and
    ``sequence`` are not the mode's (the last two refused); the metric
    ``transformer_pp_train_tokens_per_sec``, with ``n_micro``.

    ``timed(steps)``, given, is a context entered around the timed
    batches, ``steps`` training steps in all (``chip_smoke.py`` counts
    the kernels' launches in it).

    ``comm``, given, is the world's comm: every rank of it calls ``run``
    and runs the step on the :func:`train_mesh_shape` mesh, ``batch``
    per dp rank and ``seq`` per sp rank, as the JAX bench does.  Every
    decision and reading is the slowest rank's (a MAX allreduce); the
    record, the same on every rank, names the mesh, and the peak memory
    is the largest rank's, each rank's in ``peak_memory_gb_ranks``."""
    from mpi4jax_tpu_torch.models import moe_transformer as moe
    from mpi4jax_tpu_torch.models import pp_transformer as ppt
    from mpi4jax_tpu_torch.models import transformer as tfm
    from mpi4jax_tpu_torch.utils.runtime import (
        drain,
        resolve_device,
        slowest,
    )

    if mode not in ("dense", "moe", "pp"):
        raise ValueError(
            f"mode must be 'dense', 'moe' or 'pp', got {mode!r}")
    if ce_chunk and mode != "dense":
        # a silent fallback to the streaming loss would mislabel the
        # record (benchmarks/transformer.py refuses it too)
        raise ValueError(f"ce_chunk is dense-mode only (got mode={mode!r})")
    if sequence != "ring" and mode == "moe":
        raise ValueError(
            f"the MoE step's attention is the ring (got sequence="
            f"{sequence!r})")
    if sequence != "ring" and mode == "pp":
        raise ValueError(
            f"the pp step's stages attend whole sequences, it has no sp "
            f"axis (got sequence={sequence!r})")
    device = resolve_device(device)
    n = 1 if comm is None else comm.size
    dtype = torch.bfloat16 if bf16 else torch.float32
    # every rank draws the same full weights and global batch, and
    # keeps its shards; the step takes its (dp, sp) block
    gen = torch.Generator(device=device).manual_seed(0)
    if mode == "pp":
        shape, sp_size = pp_mesh_shape(n), 1
        world = mesh_comm(comm, ("dp", "pp"), shape)
        dp, pp = world.sub("dp"), world.sub("pp")
        rounded = max(layers, pp.size) - max(layers, pp.size) % pp.size
        if rounded != layers:
            print(f"[transformer-bench] pp: layers {layers} -> {rounded} "
                  f"(multiple of {pp.size} stages)", file=sys.stderr)
        layers = rounded
        micro = micro or min(4, batch)
        if batch % micro:
            raise ValueError(
                f"--batch {batch} must be divisible by the microbatch "
                f"count {micro} (pass --micro)")
        attn_impl = "xla"
        cfg = tfm.TransformerConfig(
            vocab=vocab, d_model=d_model, layers=layers, heads=heads,
            kv_heads=kv_heads, head_dim=d_model // heads, d_ff=d_ff,
            attn_impl=attn_impl,
        )
        params = tfm.init_params(cfg, generator=gen, dtype=dtype,
                                 device=device)
        if pp.size > 1:
            params = ppt.shard_params(params, pp)
        step = ppt.make_global_train_step(dp, pp, cfg, n_micro=micro,
                                          lr=1e-3, device=device)
    else:
        shape = train_mesh_shape(n)
        world = mesh_comm(comm, ("dp", "tp", "sp"), shape)
        dp, tp, sp = world.sub("dp"), world.sub("tp"), world.sub("sp")
        sp_size = sp.size
        if mode == "moe":
            attn_impl = "auto"
            cfg = moe.MoEConfig(
                vocab=vocab, d_model=d_model, layers=layers, heads=heads,
                kv_heads=kv_heads, head_dim=d_model // heads,
                experts=4 * sp.size, d_ff=d_ff,
            )
            params = moe.init_params(cfg, generator=gen, dtype=dtype,
                                     device=device)
            if tp.size * sp.size > 1:
                params = moe.shard_params(params, tp, sp)
            step = moe.make_global_train_step(dp, tp, sp, cfg, lr=1e-3,
                                              device=device)
        else:
            cfg = tfm.TransformerConfig(
                vocab=vocab, d_model=d_model, layers=layers, heads=heads,
                kv_heads=kv_heads, head_dim=d_model // heads, d_ff=d_ff,
                attn_impl=attn_impl, ce_chunk=ce_chunk,
            )
            params = tfm.init_params(cfg, generator=gen, dtype=dtype,
                                     device=device)
            if tp.size > 1:
                params = tfm.shard_params(params, tp)
            step = tfm.make_global_train_step(dp, tp, sp, cfg, lr=1e-3,
                                              sequence=sequence, remat=remat,
                                              donate=True, device=device)
    b, s = batch * dp.size, seq * sp_size
    tokens = torch.randint(0, vocab, (b, s), generator=gen, device=device)
    data = (tokens, torch.roll(tokens, -1, dims=1))

    # model FLOPs count the active parameters: a token meets one
    # expert's FFN of the E (benchmarks/transformer.py's rule)
    if mode == "moe":
        n_params, n_active = moe.active_params(cfg)
    else:
        n_params = sum(math.prod(shp)
                       for shp in tfm._leaves(tfm._param_shapes(cfg)))
        n_active = n_params
    tokens_per_step = b * s

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    params, loss = step(params, data)  # builds the kernels, warms up
    drain(loss)

    t0 = time.perf_counter()
    params, loss = step(params, data)
    drain(loss)
    per_step, = slowest(comm, [max(time.perf_counter() - t0, 1e-4)], device)
    steps = max(4, min(50, int(1.0 / per_step)))

    walls = []
    with (timed or (lambda n: contextlib.nullcontext()))(batches * steps):
        for _ in range(batches):
            t0 = time.perf_counter()
            for _ in range(steps):
                params, loss = step(params, data)
            drain(loss)
            walls.append(time.perf_counter() - t0)
    best = min(slowest(comm, walls, device)) / steps
    if not torch.isfinite(loss).all():
        raise RuntimeError(f"the training loss diverged: {loss}")

    model_tflops = 6.0 * n_active * tokens_per_step / best / 1e12
    incl_attn_tflops = (model_tflops
                        + attention_flops(cfg, b, s) / best / 1e12)
    rec = {
        "metric": ("transformer_train_tokens_per_sec" if mode == "dense"
                   else f"transformer_{mode}_train_tokens_per_sec"),
        "value": tokens_per_step / best,
        "unit": "tokens/s",
        "devices": n,
        "mesh": list(shape),
        "params_m": n_params / 1e6,
        "params_active_m": n_active / 1e6,
        "layers": layers,
        **({"n_micro": micro} if mode == "pp" else {}),
        "dtype": "bf16" if bf16 else "f32",
        "batch": batch,
        "seq": seq,
        "step_ms": best * 1e3,
        "model_tflops_per_sec": model_tflops,
        "model_tflops_incl_attn": incl_attn_tflops,
        **({"remat": list(remat) if isinstance(remat, (tuple, list))
            else remat} if mode == "dense" else {}),
        **({"ce_chunk": ce_chunk} if ce_chunk else {}),
        "attn_impl": attn_impl,
        **({"sequence": sequence} if sp_size > 1 else {}),
        "loss": float(loss[0]),
        "steps_per_batch": steps,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
    }
    if on_card:
        peaks = [row[0] for row in world_readings(
            comm, [torch.cuda.max_memory_allocated(device) / 1e9], device)]
        rec["peak_memory_gb"] = max(peaks)
        if n > 1:
            rec["peak_memory_gb_ranks"] = peaks
    peak = _peak_tflops(device) if bf16 else None
    if peak:
        rec["mfu_pct"] = 100.0 * model_tflops / (peak * n)
        rec["mfu_incl_attn_pct"] = 100.0 * incl_attn_tflops / (peak * n)
    return rec


# run's keyword defaults, from which preset_run fills a preset
RUN_DEFAULTS = {name: param.default
                for name, param in inspect.signature(run).parameters.items()}


def preset_run(preset, attn_impl="auto", **overrides):
    """``run`` of ``preset`` (an entry of ``SIZES``, or ``{}`` for
    ``run``'s defaults) with ``overrides``, each of which wins over the
    preset unless it is None: the one place a preset becomes a run.  The
    preset's ``remat`` applies unless ``remat`` is given; its own
    attention wins over ``"auto"`` and ``"autotune"`` (long's dense leg
    would hold [8192, 8192] scores per head); ``"autotune"`` times flash
    against the dense attention at the run's shape
    (:func:`autotune_attn_impl`)."""
    kw = {**RUN_DEFAULTS, **preset}
    kw.update((key, value) for key, value in overrides.items()
              if value is not None)
    if attn_impl not in ("auto", "autotune") or "attn_impl" not in preset:
        kw["attn_impl"] = attn_impl
    if kw["mode"] == "moe":
        kw["attn_impl"] = "auto"  # the MoE step's own attention
    elif kw["mode"] == "pp":
        kw["attn_impl"] = "xla"  # the pipeline stage's own attention
    if kw["attn_impl"] == "autotune":
        kw["attn_impl"] = autotune_attn_impl(
            batch=kw["batch"], seq=kw["seq"], heads=kw["heads"],
            head_dim=kw["d_model"] // kw["heads"], device=kw["device"],
            comm=kw["comm"])
    return run(**kw)


def remat_policy(text, error):
    """``--remat-policy``'s value as the step's ``remat``: ``full`` is
    True, ``dots`` and ``names`` themselves, ``save:A,B`` the tuple
    ``("A", "B")``; anything else calls ``error`` with
    ``benchmarks/transformer.py``'s message."""
    if text == "full":
        return True
    if text.startswith("save:"):
        tags = tuple(t for t in text[5:].split(",") if t)
        if not tags:
            error("save: needs at least one tag (e.g. save:attn_out)")
        return tags
    if text in ("dots", "names"):
        return text
    error(f"--remat-policy must be full, dots, names or "
          f"save:TAG[,TAG...], got {text!r}")


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--size", choices=sorted(SIZES), default=None,
                   help="a preset of benchmarks/transformer.py; explicit "
                   "flags override it")
    for flag in ("batch", "seq", "layers", "d-model", "heads", "kv-heads",
                 "d-ff"):
        p.add_argument(f"--{flag}", type=int, default=None)
    p.add_argument("--vocab", type=int, default=32768)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="recompute each layer in the backward")
    p.add_argument(
        "--remat-policy", default=None,
        help="checkpoint policy (overrides the preset's): full = save "
        "nothing per layer, dots = save every projection's output, names "
        "= save q/k/attn-out/mlp-out only, or save:TAG[,TAG...] for a "
        "save-list drawn from qkv/v_proj/attn_out/mlp_out",
    )
    p.add_argument("--attn-impl", choices=("auto", "flash", "xla",
                                           "autotune"), default="auto",
                   help="single-device attention; 'autotune' times flash "
                   "against the dense attention and keeps the faster")
    p.add_argument("--batches", type=int, default=8,
                   help="timed batches (the best is taken)")
    p.add_argument("--mode", choices=("dense", "moe", "pp"),
                   default="dense",
                   help="the dense transformer, the MoE model (4 experts "
                   "a sp rank; no remat, attention 'auto') or the dense "
                   "model as a GPipe pipeline (min(ranks, 4) stages; no "
                   "remat, attention 'xla')")
    p.add_argument("--micro", type=int, default=None,
                   help="pp microbatches (default min(4, batch))")
    p.add_argument(
        "--device", default="cuda",
        help="'cuda' (default; the hand-written kernels) or 'cpu' (their "
        "plain PyTorch versions)",
    )
    args = p.parse_args(argv)
    preset = SIZES[args.size] if args.size else {}
    remat = (remat_policy(args.remat_policy, p.error) if args.remat_policy
             else preset.get("remat", False) or args.remat)
    comm, device = None, args.device
    if "RANK" in os.environ:
        # a torchrun job: every rank runs the step on run's mesh
        from mpi4jax_tpu_torch.parallel import distributed

        device = distributed.initialize(device)
        comm = distributed.world_comm()
    rec = preset_run(
        preset, attn_impl=args.attn_impl, remat=remat, vocab=args.vocab,
        bf16=args.bf16, batches=args.batches, device=device,
        mode=args.mode, micro=args.micro, comm=comm,
        **{key: getattr(args, key) for key in (
            "batch", "seq", "layers", "d_model", "heads", "kv_heads",
            "d_ff")})
    if comm is None or comm.rank() == 0:
        print(json.dumps(rec), flush=True)
    if comm is not None:
        distributed.finalize()
    return rec


if __name__ == "__main__":
    main()
