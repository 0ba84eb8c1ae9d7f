"""Per-scan engine CLI — the `APD` binary equivalent (reference:
main.cpp:7-41), with the JAX engine's flags plus ``--device``.

Usage:
    python -m apde_mvs_tpu_torch.cli.apd --dense_folder <scan> \
        [--dataset General] [--device cuda|cpu] [--gpu_index 0] ...

``--views_parallel true`` raises (the port runs one view at a time on one
card; view-parallel passes are not ported), and ``--view_batch`` is
accepted and ignored.
"""

from __future__ import annotations

import argparse
import contextlib
import sys


def _bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="apd",
                                description="PyTorch/CUDA APD engine")
    p.add_argument("--dense_folder", "-d", required=True,
                   help="path to dense folder")
    p.add_argument("--gpu_index", "-g", type=int, default=0,
                   help="local CUDA device this engine process binds to "
                        "(reference: cudaSetDevice, main.cpp:264)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="compute device; cuda raises when no card is "
                        "visible")
    p.add_argument("--dataset", "-D", default="DTU",
                   help="dataset name, DTU, ETH3D, TaT_a, TaT_i or General")
    p.add_argument("--only_fuse", "-f", type=_bool, default=False)
    p.add_argument("--no_fuse", "-F", type=_bool, default=False)
    p.add_argument("--memory_cache", "-m", type=_bool, default=True)
    p.add_argument("--use_sa", "-s", type=_bool, default=True)
    p.add_argument("--use_impetus", "-i", type=_bool, default=True)
    p.add_argument("--weak_filter", "-w", type=_bool, default=True)
    p.add_argument("--flush", type=_bool, default=False)
    p.add_argument("--export_anchor", "-n", type=_bool, default=False)
    p.add_argument("--export_curve", "-r", type=_bool, default=False)
    p.add_argument("--export_color", "-c", type=_bool, default=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pyramid_base", type=int, default=800)
    p.add_argument("--views_parallel", type=str, default="auto",
                   choices=["auto", "true", "false"],
                   help="not ported: only auto/false (serial views) run")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the run (CPU and "
                        "CUDA activities, Chrome/Perfetto JSON) into this "
                        "directory")
    p.add_argument("--view_batch", type=int, default=None,
                   help="view-parallel batch cap (ignored: views run "
                        "serially)")
    p.add_argument("--fuse_shard", type=str, default=None,
                   help="distributed fusion: 'i,n' fuses ref views i mod n "
                        "into a partial PLY")
    p.add_argument("--merge_fusion", type=int, default=None,
                   help="merge N partial fusion PLYs into APD.ply and exit")
    p.add_argument("--start_iteration", type=int, default=0,
                   help="skip schedule passes below this iteration index")
    p.add_argument("--sampler", type=str, default="u8",
                   choices=["u8", "f32"],
                   help="source sampling table dtype: u8 quads (default) or "
                        "f32 quads (exact oracle)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.views_parallel == "true":
        raise NotImplementedError(
            "--views_parallel: view-parallel passes not ported yet")
    only_fuse = args.only_fuse
    print("========================== Config ==========================")
    for k, v in sorted(vars(args).items()):
        print(f"{k:14s}: {v}")
    print("============================================================")

    if args.view_batch is not None:
        print(f"--view_batch {args.view_batch} ignored: the port runs views "
              "one at a time", flush=True)

    from ..core.platform import bind_device, profile_trace
    from ..pipeline.driver import run_scan

    device = bind_device(args.gpu_index, args.device)

    if args.merge_fusion:
        from ..pipeline.fusion import merge_fusion_shards
        merge_fusion_shards(args.dense_folder, "APD.ply", args.merge_fusion,
                            export_color=args.export_color)
        return 0

    fuse_shard = None
    if args.fuse_shard:
        i, n = (int(v) for v in args.fuse_shard.split(","))
        fuse_shard = (i, n)

    prof = contextlib.nullcontext()
    if args.profile_dir:
        prof = profile_trace(args.profile_dir, device)
    with prof:
        run_scan(
            args.dense_folder, dataset=args.dataset, device=device,
            only_fuse=only_fuse, no_fuse=args.no_fuse,
            use_memory_cache=args.memory_cache and not only_fuse,
            use_sa=args.use_sa, use_impetus=args.use_impetus,
            weak_filter=args.weak_filter, flush=args.flush or args.no_fuse,
            export_anchor=args.export_anchor,
            export_curve=args.export_curve, export_color=args.export_color,
            seed=args.seed, pyramid_base=args.pyramid_base,
            fuse_shard=fuse_shard, sampler_u8=(args.sampler == "u8"),
            start_iteration=args.start_iteration)
    return 0


if __name__ == "__main__":
    sys.exit(main())
