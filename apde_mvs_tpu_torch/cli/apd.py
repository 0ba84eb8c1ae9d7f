"""Per-scan engine CLI — the `APD` binary equivalent (reference:
main.cpp:7-41), with the JAX engine's flags plus ``--device``.

Usage:
    python -m apde_mvs_tpu_torch.cli.apd --dense_folder <scan> \
        [--dataset General] [--device cuda|cpu] [--gpu_index 0] ...

Scale-out: under ``python -m torch.distributed.run --nproc_per_node N -m
apde_mvs_tpu_torch.cli.apd ...`` each rank binds ``cuda:LOCAL_RANK``
(modulo the card count), joins the process group (NCCL when every rank
has a card of its own, gloo when ranks share one or run on the CPU) and
``--views_parallel`` (auto = more than one rank) splits the scan's views
over the ranks, ``--view_batch`` views a batch; rank 0 fuses after the
last pass.
"""

from __future__ import annotations

import argparse
import contextlib
import os
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
                   help="split each pass's views over the ranks of the "
                        "process group (auto: when there is more than one "
                        "rank); fewer views than ranks row-shards each view")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the run (CPU and "
                        "CUDA activities, Chrome/Perfetto JSON) into this "
                        "directory")
    p.add_argument("--view_batch", type=int, default=None,
                   help="views per view-parallel batch (default: sized "
                        "from the card's free memory; the whole scan on "
                        "the CPU)")
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
    print("========================== Config ==========================")
    for k, v in sorted(vars(args).items()):
        print(f"{k:14s}: {v}")
    print("============================================================")

    import torch.distributed as dist

    from ..core.platform import bind_device
    from ..parallel import distributed as pdist

    # under torchrun each rank binds its own local card
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    device = bind_device(args.gpu_index + local_rank, args.device)
    rank, _ = pdist.initialize(device)
    try:
        if rank == 0 or not args.merge_fusion:
            _run(args, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def _run(args, device) -> None:
    from ..core.platform import profile_trace
    from ..pipeline.driver import run_scan

    if args.merge_fusion:
        from ..pipeline.fusion import merge_fusion_shards
        merge_fusion_shards(args.dense_folder, "APD.ply", args.merge_fusion,
                            export_color=args.export_color)
        return

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
            only_fuse=args.only_fuse, no_fuse=args.no_fuse,
            use_memory_cache=args.memory_cache and not args.only_fuse,
            use_sa=args.use_sa, use_impetus=args.use_impetus,
            weak_filter=args.weak_filter, flush=args.flush or args.no_fuse,
            export_anchor=args.export_anchor,
            export_curve=args.export_curve, export_color=args.export_color,
            seed=args.seed, pyramid_base=args.pyramid_base,
            fuse_shard=fuse_shard, sampler_u8=(args.sampler == "u8"),
            start_iteration=args.start_iteration,
            views_parallel={"auto": None, "true": True,
                            "false": False}[args.views_parallel],
            view_batch=args.view_batch)


if __name__ == "__main__":
    sys.exit(main())
