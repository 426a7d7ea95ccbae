"""How far each AOTInductor package of the serving forward lies from the
eager forward at each precision, on the card.

The 12-iteration forward of random weights is chaotic: any change in its
arithmetic grows from iteration to iteration. This tool reads how far the
packages of ``serving.aot_compile`` lie from eager, and from eager one
step down in precision, at 1 and at 12 iterations, to find what a gate on
a package can tell apart.

For each seed's weights and each iteration count: three eager flows, fp32
``precision="highest"``, fp32 with TF32 convolutions (``precision=None``
at torch's default flags) and bf16 mixed precision. Each package variant
(precision x iterations x Inductor's ``emulate_precision_casts``) is
compiled in a process of its own, side by side, then called with each
seed's state at torch's default flags, as a server would call it; each
reading is max |a - b| / max |b| (the flow scale of ``b``). With
``--profile``, one call of each long package and of each eager forward
under torch.profiler: device-busy ms, kernel count, the convolution
kernels and how many of them are bf16 or TF32 by name.

    python -m prior_flow_tpu_torch.tools.serving_precision \\
        [--size 512 1024] [--iters 1 12] [--seeds 0 1] [--profile] \\
        [--out DIR]

AOTInductor links a package with ``-fopenmp``: ``$CXX`` must link OpenMP.
One JSON line at the end; every kernel of each profile goes to
``DIR/serving_precision_profile.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from ..models import build_model
from ..serving import aot_compile
from ..serving.export import CompiledForward
from ._timing import nvidia_smi

REFS = ("fp32", "tf32", "bf16")


def variants(short: int, long: int) -> list:
    """The package variants: (precision, iterations, Inductor's
    ``emulate_precision_casts``)."""
    return [("fp32", short, False), ("fp32", long, False),
            ("bf16", short, False), ("bf16", short, True),
            ("bf16", long, False), ("bf16", long, True)]


def _name(variant) -> str:
    tag, iters, emulate = variant
    return f"{tag}_{iters}it" + ("_emulate" if emulate else "")


def eager_model(ref: str, seed: int, dev):
    """The eager model of reference ``ref``: fp32 "highest", TF32
    convolutions (precision None, run at torch's default flags) or bf16."""
    return build_model(dev, seed=seed, mixed_precision=ref == "bf16",
                       precision=None if ref == "tf32" else "highest")


def _images(h: int, w: int, dev):
    g = torch.Generator().manual_seed(0)
    return tuple((torch.rand(1, h, w, 3, generator=g) * 255).to(dev)
                 for _ in range(2))


def compile_one(path: str, tag: str, iters: int, emulate: bool, h: int,
                w: int, dev) -> None:
    """Compiles one package variant (in a process of its own)."""
    from ..serving import export
    export.INDUCTOR_CONFIGS = {"emulate_precision_casts": emulate}
    model = eager_model("bf16" if tag == "bf16" else "fp32", 0, dev)
    t0 = time.perf_counter()
    aot_compile(model, model.state_dict(), (1, h, w), iters,
                package_path=path, device=dev)
    print(json.dumps({"compile_s": time.perf_counter() - t0}))


def ratio(a, b) -> float:
    """max |a - b| / max |b|."""
    return (a - b).abs().max().item() / b.abs().max().item()


def kernel_events(fn) -> list:
    """(device ms, launches, name) of each CUDA kernel of one profiled call
    of ``fn``, longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [(e.self_device_time_total / 1e3, e.count, e.key)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    return sorted(events, reverse=True)


def conv_kernels(events) -> dict:
    """{name: launches} of the cuDNN convolution kernels among
    ``kernel_events``' (not Inductor's Triton kernels, whose names may
    carry "convolution" from a fused bias)."""
    return {name: n for _, n, name in events
            if not name.startswith("triton")
            and any(k in name.lower() for k in ("fprop", "convolve", "fft"))}


def precision_by_name(convs: dict, tag: str) -> bool:
    """Whether the convolution kernels ``convs`` run at ``tag``'s precision
    by their names: fp32 none TF32, bf16 every one bf16."""
    low = [n.lower() for n in convs]
    if tag == "fp32":
        return bool(low) and not any("tf32" in n for n in low)
    return bool(low) and all("bf16" in n or "bfloat16" in n for n in low)


def _profile(fn) -> dict:
    """Device-busy ms, kernel count and convolution kernels of one call
    after a warm-up."""
    fn()
    torch.cuda.synchronize()
    events = kernel_events(fn)
    convs = conv_kernels(events)
    return {
        "busy_ms": sum(ms for ms, _, _ in events),
        "kernels": sum(n for _, n, _ in events),
        "conv_kernels": sum(convs.values()),
        "conv_kernels_bf16": sum(n for name, n in convs.items()
                                 if "bf16" in name.lower()
                                 or "bfloat16" in name.lower()),
        "conv_kernels_tf32": sum(n for name, n in convs.items()
                                 if "tf32" in name.lower()),
        "conv_ms": sum(ms for ms, _, name in events if name in convs),
        "top": [(round(ms, 4), n, name[:160]) for ms, n, name in events]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, nargs=2, default=(512, 1024))
    ap.add_argument("--iters", type=int, nargs=2, default=(1, 12),
                    metavar=("SHORT", "LONG"))
    ap.add_argument("--seeds", type=int, nargs="+", default=(0, 1))
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cpu: a dry run of the tool at a small --size")
    ap.add_argument("--out", default=os.path.join("build",
                                                  "serving_precision"))
    ap.add_argument("--compile", nargs=4, metavar=("PATH", "TAG", "ITERS",
                                                   "EMULATE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    h, w = args.size
    if args.compile:
        path, tag, iters, emulate = args.compile
        compile_one(path, tag, int(iters), emulate == "1", h, w, args.device)
        return
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serving_precision needs the card")
    if args.profile and dev.type != "cuda":
        raise SystemExit("--profile profiles the card")
    os.makedirs(args.out, exist_ok=True)
    if dev.type == "cuda":   # the kernels, built once before the compiles
        from ..ops.kernels import _build
        _build.load_library()
    todo = variants(*args.iters)
    t_compile = time.perf_counter()
    procs = {}
    for v in todo:
        path = os.path.abspath(os.path.join(args.out, f"{_name(v)}.pt2"))
        procs[v] = (path, subprocess.Popen(
            [sys.executable, "-m", __spec__.name, "--size", str(h), str(w),
             "--device", args.device, "--compile", path, v[0], str(v[1]),
             str(int(v[2]))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        i1, i2 = _images(h, w, dev)
        eager = {}
        for seed in args.seeds:
            for iters in sorted({v[1] for v in todo}):
                for ref in REFS:
                    with torch.no_grad():
                        eager[seed, iters, ref] = eager_model(ref, seed, dev)(
                            i1, i2, iters=iters)
        distance = {f"seed{s}_{it}it": {
            f"{ref}_vs_fp32": ratio(eager[s, it, ref], eager[s, it, "fp32"])
            for ref in ("tf32", "bf16")}
            for s, it, ref in eager if ref == "fp32"}
        print(f"eager one step down in precision: {distance}", flush=True)
        compile_s = {}
        for v, (path, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=3000)
            if proc.returncode != 0:
                raise SystemExit(f"{_name(v)} failed to compile:\n"
                                 f"{stderr[-3000:]}")
            compile_s[_name(v)] = json.loads(
                stdout.strip().splitlines()[-1])["compile_s"]
        print(f"compiled side by side in "
              f"{time.perf_counter() - t_compile:.1f} s: {compile_s}",
              flush=True)
        readings, profiles = {}, {}
        for v, (path, _) in procs.items():
            tag, iters, _ = v
            compiled = CompiledForward(path)
            for seed in args.seeds:
                state = eager_model("bf16" if tag == "bf16" else "fp32", seed,
                               dev).state_dict()
                got = compiled(state, i1, i2)
                readings[f"{_name(v)}_seed{seed}"] = {
                    ref: ratio(got, eager[seed, iters, ref]) for ref in REFS}
                print(f"{_name(v)} seed {seed}: "
                      f"{readings[f'{_name(v)}_seed{seed}']}", flush=True)
            if args.profile and iters == args.iters[1]:
                state = eager_model(tag, 0, dev).state_dict()
                profiles[_name(v)] = _profile(
                    lambda: compiled(state, i1, i2))
            del compiled
            torch.cuda.empty_cache()
        if args.profile:
            for ref in REFS:
                model = eager_model(ref, 0, dev)
                with torch.no_grad():
                    profiles[f"{ref}_{args.iters[1]}it_eager"] = _profile(
                        lambda: model(i1, i2, iters=args.iters[1]))
            with open(os.path.join(args.out,
                                   "serving_precision_profile.txt"), "w") as f:
                for k, p in profiles.items():
                    brief = {x: y for x, y in p.items() if x != "top"}
                    f.write(f"{k}: {json.dumps(brief)}\n")
                    for row in p["top"]:
                        f.write(f"  {row}\n")
            for k, p in profiles.items():
                print(f"profile {k}: " + json.dumps(
                    {x: y for x, y in p.items() if x != "top"}), flush=True)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if dev.type == "cuda":
        print(nvidia_smi("name,power.limit"))
    print(json.dumps({"size": [h, w], "distance": distance,
                      "readings": readings, "compile_s": compile_s,
                      "profiles": {k: {x: y for x, y in p.items()
                                       if x != "top"}
                                   for k, p in profiles.items()}}))


if __name__ == "__main__":
    main()
