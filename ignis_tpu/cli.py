"""igcli-equivalent command line frontend.

Parity target: /root/reference/src/frontend/cli/main.cpp +
frontend/common/ProgramOptions.cpp (scene file, spp/spi, output, seed,
film overrides, per-run `# min/med/max Msamples/s` summary line).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="igtpu", description="ignis_tpu renderer CLI")
    p.add_argument("scene", help="Scene file (JSON)")
    p.add_argument("-o", "--output", default="output.exr",
                   help="Output image path (.exr/.png/.hdr)")
    p.add_argument("--spp", type=int, default=64,
                   help="Total samples per pixel")
    p.add_argument("--spi", type=int, default=1,
                   help="Samples per iteration")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--spp-mode", choices=["fixed", "capped"], default="fixed")
    p.add_argument("--timeout", type=float, default=0.0,
                   help="Render time budget in seconds (0 = unlimited)")
    p.add_argument("--instancing", action="store_true",
                   help="two-level accel: meshes reused by several "
                        "entities are stored once with per-instance "
                        "transforms (LoaderEntity.cpp two-level BVH)")
    p.add_argument("--denoise", action="store_true",
                   help="AOV-guided denoise before writing the output")
    p.add_argument("--stats", action="store_true")
    # device targeting (ProgramOptions --gpu/--cpu/--device/--threads)
    p.add_argument("--target", choices=["auto", "gpu", "cpu"],
                   default="auto",
                   help="Backend platform (reference --gpu/--cpu analog); "
                        "gpu fails without a CUDA device, auto reports "
                        "its choice on stderr")
    p.add_argument("--device", type=int, default=None,
                   help="Device index within the platform")
    p.add_argument("--json", action="store_true",
                   help="Print one summary JSON line")
    # user parameter injection (ProgramOptions.cpp:151-235)
    p.add_argument("--Pi", "--parameter-int", nargs=2, action="append",
                   default=[], metavar=("NAME", "VALUE"),
                   help="Set integer value in the global registry")
    p.add_argument("--Pn", "--parameter-num", nargs=2, action="append",
                   default=[], metavar=("NAME", "VALUE"),
                   help="Set number value in the global registry")
    p.add_argument("--Pv", "--parameter-vec", nargs=4, action="append",
                   default=[], metavar=("NAME", "X", "Y", "Z"),
                   help="Set vector value in the global registry")
    p.add_argument("--Pc", "--parameter-col", nargs=4, action="append",
                   default=[], metavar=("NAME", "R", "G", "B"),
                   help="Set color value in the global registry")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax
    if args.target == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif args.target == "gpu":
        try:
            jax.config.update("jax_default_device", jax.devices("cuda")[0])
        except RuntimeError:
            print("error: --target gpu requested but no CUDA device is "
                  "available", file=sys.stderr)
            return 2
    else:
        print(f"[target] {jax.devices()[0].platform}", file=sys.stderr)
    from . import Runtime
    from .utils.image import save_image
    if args.device is not None:
        devs = jax.devices()
        if not 0 <= args.device < len(devs):
            print(f"error: --device {args.device} out of range "
                  f"(have {len(devs)})", file=sys.stderr)
            return 2
        jax.config.update("jax_default_device", devs[args.device])

    overrides = {"spi": args.spi, "seed": args.seed}
    if args.width:
        overrides["width"] = args.width
    if args.height:
        overrides["height"] = args.height
    if args.instancing:
        overrides["instancing"] = True

    t0 = time.time()
    rt = Runtime.load_from_file(args.scene, **overrides)
    params_set = False
    for name, v in args.Pi:
        rt.setParameter(name, int(v))
        params_set = True
    for name, v in args.Pn:
        rt.setParameter(name, float(v))
        params_set = True
    for entry in args.Pv + args.Pc:
        rt.setParameter(entry[0], [float(x) for x in entry[1:]])
        params_set = True
    if params_set:
        rt._refresh_parameters()
    for wmsg in rt.warnings:
        print(f"[warn] {wmsg}", file=sys.stderr)
    load_time = time.time() - t0

    iters = max(1, args.spp // max(args.spi, 1))
    w, h = rt.framebuffer_width, rt.framebuffer_height
    samples_per_iter = w * h * rt.settings.spi

    iter_times = []
    t_start = time.time()
    for i in range(iters):
        it0 = time.time()
        jax.block_until_ready(rt.step()._film)
        iter_times.append(time.time() - it0)
        if args.timeout > 0 and time.time() - t_start > args.timeout:
            break

    img = (rt.denoised_framebuffer() if args.denoise
           else rt.framebuffer(normalized=True))
    save_image(args.output, img)

    # First iteration includes compile; report steady-state like the
    # reference (cli/main.cpp:171 min/med/max Msamples/s over iterations)
    rates = [samples_per_iter / t / 1e6 for t in iter_times]
    mn, md, mx = min(rates), statistics.median(rates), max(rates)
    print(f"# {min(iter_times):.3f}/{statistics.median(iter_times):.3f}/"
          f"{max(iter_times):.3f} ({mn:.3f}/{md:.3f}/{mx:.3f} Msamples/s)")
    if args.stats:
        print(f"Load: {load_time:.2f}s  Iterations: {rt.iteration_count}  "
              f"SPP: {rt.sample_count}")
        q = rt.acquireStats()
        if q:
            print("Quantities (one instrumented iteration): "
                  + "  ".join(f"{k}={v}" for k, v in sorted(q.items())))
        print(rt.stats.dump(total_iters=rt.iteration_count))
    if args.json:
        print(json.dumps({
            "scene": args.scene, "spp": rt.sample_count,
            "msamples_per_s_median": md, "iterations": rt.iteration_count,
            "wall_s": time.time() - t_start,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
