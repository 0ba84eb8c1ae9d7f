"""Process groups and the collectives of the scale-out engines, and scan
partitioning across hosts.

The reference scales out as `gpu_num x work_num` engine processes on one
machine (run.py:218-226). The port's view-parallel and tile engines run one
process per rank under ``torchrun`` (or explicit arguments): `initialize`
brings up ``torch.distributed`` and chooses the backend from the
placement alone:

- ``nccl`` when every rank of a node has a card of its own;
- ``gloo`` when ranks share a card (more local ranks than cards) or the
  engine runs on the CPU. NCCL refuses two ranks on one device.

There is no other fallback: a group that fails to come up raises.

The collectives move CUDA tensors straight through NCCL. Under gloo a CUDA
tensor is staged through host memory (gloo's CUDA support differs by
collective: send / recv take CPU tensors only); the compute stays on the
card. `exchanged_bytes` counts what this rank sent.

`partition_scans` and `throughput_report` are host code, as in the JAX
package: LPT assignment of scans to hosts and scans-per-hour with scaling
efficiency.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# bytes this rank has sent through the collectives below (a counter the
# engines print per pass and the tests read)
exchanged_bytes = 0


def backend_for(device: torch.device, local_world_size: int) -> str:
    """``nccl`` when each local rank has a card of its own, else ``gloo``
    (ranks sharing a card, or the CPU)."""
    if torch.device(device).type == "cuda" \
            and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(device="cuda", init_method: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None) -> Tuple[int, int]:
    """Join the process group this process belongs to; returns
    ``(rank, world_size)``.

    The group comes from explicit arguments (``init_method`` such as
    ``tcp://localhost:29500`` or ``file:///path``, with ``rank`` and
    ``world_size``), else from the torchrun environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` /
    ``MASTER_PORT``). With neither it is a no-op returning (0, 1). A CUDA
    ``device`` must already be bound (`core.platform.bind_device`)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if init_method is None:
        if "WORLD_SIZE" not in os.environ:
            return 0, 1
        init_method = "env://"
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    backend = backend_for(device, local)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    print(f"rank {rank} of {world_size}: process group backend {backend} "
          f"({local} local rank(s), {torch.cuda.device_count()} card(s), "
          f"device {device})", flush=True)
    return rank, world_size


def rank_and_world() -> Tuple[int, int]:
    """This process's (rank, world size); (0, 1) without a group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier() -> None:
    """Wait for every rank (a no-op without a group)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _wire(t: torch.Tensor) -> torch.Tensor:
    """What goes over the wire: bool as uint8, and under gloo a CUDA tensor
    staged to host memory."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if t.is_cuda and dist.get_backend() == "gloo":
        t = t.cpu()
    return t.contiguous()


def _count(t: torch.Tensor) -> None:
    global exchanged_bytes
    exchanged_bytes += t.numel() * t.element_size()


def all_gather_parts(t: torch.Tensor, counts: Sequence[int]) -> torch.Tensor:
    """Concatenate every rank's ``t`` along dim 0 in rank order; rank r
    holds ``counts[r]`` rows (ranks may differ: each part is padded to the
    largest for the collective). The identity without a group."""
    if not dist.is_initialized():
        return t
    m = max(counts)
    x = _wire(t)
    if x.shape[0] < m:
        x = torch.cat([x, x.new_zeros((m - x.shape[0],) + x.shape[1:])])
    parts = [torch.empty_like(x) for _ in counts]
    _count(x)
    dist.all_gather(parts, x)
    out = torch.cat([p[:c] for p, c in zip(parts, counts)])
    return out.to(device=t.device, dtype=t.dtype)


def exchange(send: Dict[tuple, torch.Tensor], recv: Dict[tuple, torch.Tensor]
             ) -> Dict[tuple, torch.Tensor]:
    """Point-to-point in one batch of isend / irecv. Keys are
    ``(peer, tag)``: ``send[k]`` goes to ``peer`` under ``tag``, and the
    message from ``peer`` under ``tag`` lands in a buffer shaped like
    ``recv[k]``. Returns the received tensors on those buffers' devices
    and dtypes."""
    ops, got = [], {}
    for (peer, tag), t in send.items():
        x = _wire(t)
        _count(x)
        ops.append(dist.P2POp(dist.isend, x, peer, tag=tag))
    for (peer, tag), like in recv.items():
        got[(peer, tag)] = torch.empty_like(_wire(like))
        ops.append(dist.P2POp(dist.irecv, got[(peer, tag)], peer, tag=tag))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return {k: got[k].to(device=recv[k].device, dtype=recv[k].dtype)
            for k in got}


def partition_scans(scans: Sequence[Tuple[str, int]], num_hosts: int,
                    host_index: int) -> List[str]:
    """LPT partition of (scan, image_count) jobs over hosts: sort by size
    descending, greedily assign each scan to the least-loaded host; return
    this host's share (deterministic across hosts)."""
    order = sorted(scans, key=lambda e: (-e[1], e[0]))
    loads = [0] * num_hosts
    mine: List[str] = []
    for scan, weight in order:
        h = loads.index(min(loads))
        loads[h] += max(weight, 1)
        if h == host_index:
            mine.append(scan)
    return mine


def throughput_report(scan_times_s: Dict[str, float], num_hosts: int,
                      single_host_baseline_s: Optional[float] = None) -> dict:
    """Scans/hour + scaling efficiency vs a single-host baseline.

    Wall clock for multi-host runs is estimated by LPT-assigning the scan
    times over hosts (the same greedy `partition_scans` uses) and taking the
    busiest host's total — `max(scan_times)` alone would underestimate the
    wall whenever a host runs more than one scan.
    """
    total = sum(scan_times_s.values())
    if num_hosts > 1 and scan_times_s:
        loads = [0.0] * num_hosts
        for t in sorted(scan_times_s.values(), reverse=True):
            loads[loads.index(min(loads))] += t
        wall = max(loads)
    else:
        wall = total
    scans_per_hour = len(scan_times_s) / max(wall, 1e-9) * 3600
    report = {
        "num_scans": len(scan_times_s),
        "num_hosts": num_hosts,
        "wall_clock_s": wall,
        "scans_per_hour": scans_per_hour,
    }
    if single_host_baseline_s:
        ideal = single_host_baseline_s / num_hosts
        report["scaling_efficiency"] = ideal / max(wall, 1e-9)
    return report
