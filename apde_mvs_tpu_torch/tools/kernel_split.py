"""Where K7's (the weak sweep's chunk update) and K8's (anchor generation)
time goes on the card, stage by stage, at the chunks the main paths give
them.

Times are device times from torch.profiler (CUDA events around a launch
also hold the host's time a call, which exceeds a short kernel's). K7 is
timed whole and in its timing-only forms (``weak_sweep.
weak_update_timing``: up to the reference side; up to the selection, the
adoption and the fit-plane test; up to the refinement hypotheses), at
three chunks of the APD scan chip_smoke.py runs (the 600x800 scene of
benchmarks/fullres_stress.py, its weak plane one SA segment, 6 views):

- (a) ``tools.kernel_times.weak_chunk``: the weak plane's reliable pixels
  on the ground-truth state, SA windows (no anchor outside the plane's
  segment counts);
- (b) the same chunk with square windows (every valid anchor counts);
- (c) the first chunk a real APD REFINE_INIT pass hands K7: the pass
  ``tools/profile_pass.py --pass apd`` profiles (the same scene with 11
  views, the priors of a FIRST_INIT pass of the same view), captured at
  the call;

each in REFINE_INIT and in a geometric REFINE_ITER form, with the work the
chunk's data gives the kernel (from the plain version's stage): the
(plane, view) pairs a pixel in each phase, the anchors that count a pair
whose centre stays in the image, and the lanes a warp round leaves idle
(K7 runs a pixel a warp, its pairs across the 32 lanes).

K8 is timed whole and in its timing-only forms (``anchors.
gen_anchors_timing``: up to the probe walk; up to the RANSAC), at a 16,384
pixel chunk of the APD scan's weak list at the APD round's rotate_time and
at the chunk a real APD pass hands it, with the walk lengths (the probes a
direction tests up to its first accepted one, or every probe whose test
point lies in the image: their mean and maximum a lane, and a warp's
longest) and the time of the jitter draw table (``anchors.anchor_raws``)
of a chunk.

    python -m apde_mvs_tpu_torch.tools.kernel_split

Needs a CUDA device. The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import json
import types

import torch

from ..core.platform import card_line
from ..ops import anchors as anc
from ..ops.cuda import anchors as kern
from ..ops.cuda import weak_sweep
from .kernel_times import (APD_VIEWS, apd_scene, cuda_ms, device_ms,
                           draw_table_ms, k7_kwargs, k8_chunk,
                           real_pass_chunks, weak_chunk)

LANES = 32


def k7_chunks(scene, dev, seed: int = 0, real=None) -> dict:
    """The step's K7 chunks as {name: (args, kwargs)}: (a) and (b) from
    ``kernel_times.weak_chunk``, (c) from ``real`` (`real_pass_chunks`),
    each in its REFINE_INIT and geometric REFINE_ITER forms."""
    wc = weak_chunk(scene, dev, seed)
    args = (wc.data, wc.state, wc.x, wc.y, wc.anchors, wc.fit, wc.draws)
    out = {}
    for tag, sa in (("a SA", True), ("b square", False)):
        for form, geom, ri in (("REFINE_INIT", False, True),
                               ("REFINE_ITER", True, False)):
            out[f"{tag}, {form}"] = (args, k7_kwargs(wc, sa, geom, ri))
    if real is not None and real.k7 is not None:
        a, kw = real.k7
        for form, geom, ri in (("REFINE_INIT", False, True),
                               ("REFINE_ITER", True, False)):
            out[f"c real pass, {form}"] = (a, dict(kw, geom=geom,
                                                    refine_init=ri))
    return out


def k7_work(args, kw) -> dict:
    """The work K7's pixels hold on this chunk (the plain version's stage):
    the pairs a pixel in phase 0 (the flagged candidates, the current plane
    and a fit plane with a normal, against every view) and phase 1 (the 5
    hypotheses against the weighted views of a pixel with a fit); the
    share of phase 0's pairs whose centre stays in the image and, of
    those, the anchors that count a pair (valid, and in the image with a
    positive weight sum or out of it with the view selected); the lanes a
    warp round leaves idle in each phase."""
    from ..testing.weak_composition import weak_taps
    data, state, x, y, anchors, fit, draws = args
    st = weak_sweep.weak_stage_plain(
        data, state, x, y, anchors, fit, draws,
        **{k: v for k, v in kw.items() if k != "refine_init"})
    s = data.num_src
    b = x.numel()
    n_slots = st.flags.sum(-1) + 1 + st.fit_ok.to(torch.int64)
    p0 = n_slots * s
    n_w = (st.vw > 0).sum(-1)
    p1 = 5 * n_w * st.fit_ok.to(torch.int64)
    params = types.SimpleNamespace(weak_radius=kw["weak_radius"],
                                   weak_increment=kw["weak_increment"])
    cand = anchors[:, 1:].clamp(min=0).long()
    planes = torch.cat([state.planes[cand[..., 1], cand[..., 0]],
                        st.cur_plane[:, None], fit[:, None]], 1)
    evaluated = torch.cat([st.flags, torch.ones_like(st.fit_ok)[:, None],
                           st.fit_ok[:, None]], 1)          # (B, 10)
    sel = st.wref.anchor_sel.permute(2, 0, 1)               # (S, B, 8)
    live = counting = windows = 0
    for c in range(planes.shape[1]):
        ev = evaluated[:, c][None].expand(s, b)
        tp = weak_taps(data, st.wref, planes[:, c], params)
        on = ev & ~tp.center_oob
        test = on[..., None] & st.wref.anchor_valid
        comp = test & ~tp.anchor_oob & (st.wref.wsum > 0)
        live += int(on.sum())
        windows += int(comp.sum())
        counting += int((comp | (test & tp.anchor_oob & sel)).sum())
        del tp

    def idle(pairs):
        rounds = (pairs + LANES - 1) // LANES
        r = int(rounds.sum())
        return (float((rounds * LANES - pairs).sum()) / r if r else 0.0,
                float(rounds.float().mean()))
    i0, r0 = idle(p0)
    i1, r1 = idle(p1)
    return dict(pixels=b, views=s,
                phase0_pairs=float(p0.float().mean()),
                phase1_pairs=float(p1.float().mean()),
                weighted_views=float(n_w.float().mean()),
                live_share=live / max(int(p0.sum()), 1),
                counting_anchors=counting / max(live, 1),
                anchor_windows=windows / max(live, 1),
                phase0_rounds=r0, phase0_idle_lanes=i0,
                phase1_rounds=r1, phase1_idle_lanes=i1)


def k7_split(args, kw, iters: int = 20) -> dict:
    """K7's device time a launch, whole and up to each stage (profiler),
    and the whole launch's by CUDA events."""
    def whole():
        return weak_sweep.weak_update_fused(*args, **kw)
    out = dict(ms=device_ms(whole, iters, "weak_update_kernel"),
               event_ms=cuda_ms(whole, iters))
    for stop, key in ((1, "ref_ms"), (2, "select_ms"), (3, "hyp_ms")):
        out[key] = device_ms(lambda: weak_sweep.weak_update_timing(
            stop, *args, **kw), iters, "weak_update_kernel")
    return out


def k8_walks(args) -> dict:
    """The probe walks of K8's directions on this chunk: the probes each
    tests (up to its first accepted one, or every probe whose test point
    lies in the image), their mean and maximum a lane (a direction) and a
    warp's longest (a pixel's longest direction), the hits a pixel and the
    share of the pixels with the 6 hits a usable RANSAC plane needs."""
    ns, _, h, w, wx, wy, sx, sy, tri, dirs = args[:10]
    d = dirs.shape[0]
    rt = d // 8
    n = wx.numel()
    in_image, ok, _, _, _ = anc.probe_table(h, w, ns, wx, wy, rt,
                                            anc.AnchorRaws(sx, sy, tri))
    ok = ok.reshape(n, d, -1)
    found = ok.any(-1)
    first = ok.to(torch.uint8).argmax(-1)
    walk = torch.where(found, first + 1,
                       in_image.reshape(n, d, -1).sum(-1))
    warp = walk.max(-1).values
    hits = found.sum(-1)
    return dict(pixels=n, directions=d,
                lane_mean=float(walk.float().mean()),
                lane_max=int(walk.max()),
                warp_mean=float(warp.float().mean()),
                warp_max=int(warp.max()),
                probes_a_direction=int(ok.shape[-1]),
                hits_mean=float(hits.float().mean()),
                ransac_share=float((hits >= 6).float().mean()))


def k8_split(args, kw, iters: int = 20) -> dict:
    """K8's device time a launch, whole and up to each stage (profiler),
    and the whole launch's by CUDA events."""
    def whole():
        return kern.gen_anchors(*args, **kw)
    out = dict(ms=device_ms(whole, iters, "gen_anchors"),
               event_ms=cuda_ms(whole, iters))
    for part, key in ((1, "walk_ms"), (2, "ransac_end_ms")):
        out[key] = device_ms(lambda: kern.gen_anchors_timing(
            part, *args, **kw), iters, "gen_anchors")
    return out


def report(scene, dev, card: str, seed: int = 0, log=print,
           real=None) -> dict:
    """Both kernels' splits and work at every chunk; prints a line each.
    ``real`` is `real_pass_chunks`' result where the caller has it."""
    real = real or real_pass_chunks(dev)
    log(f"real APD pass: {real.prior_weak} WEAK pixels in the FIRST_INIT "
        f"prior; K7's first chunk {real.k7[0][2].numel() if real.k7 else 0}"
        f" pixels, K8's {real.k8[0][4].numel() if real.k8 else 0}")
    out = {"K7": {}, "K8": {}}
    for name, (args, kw) in k7_chunks(scene, dev, seed, real).items():
        r = k7_split(args, kw)
        r.update(k7_work(args, kw))
        out["K7"][name] = r
        log(f"K7 split, {name}: {r['pixels']} pixels, whole {r['ms']:.4f} "
            f"ms ({r['event_ms']:.4f} by events), to the reference side "
            f"{r['ref_ms']:.4f}, to the selection and fit test "
            f"{r['select_ms']:.4f}, to the hypotheses {r['hyp_ms']:.4f}; "
            f"pairs a pixel phase 0 "
            f"{r['phase0_pairs']:.2f}, phase 1 {r['phase1_pairs']:.2f} "
            f"({r['weighted_views']:.2f} views weighted); centres in the "
            f"image {r['live_share']:.3f}, anchors counting a live pair "
            f"{r['counting_anchors']:.3f} ({r['anchor_windows']:.3f} "
            f"windows); idle lanes a round phase 0 "
            f"{r['phase0_idle_lanes']:.2f} ({r['phase0_rounds']:.2f} "
            f"rounds), phase 1 {r['phase1_idle_lanes']:.2f} "
            f"({r['phase1_rounds']:.2f} rounds) [{card}]")
    chunks = {"smoke chunk": k8_chunk(scene, dev, seed)}
    if real.k8 is not None:
        chunks["real pass"] = real.k8
    for name, (args, kw) in chunks.items():
        r = k8_split(args, kw)
        r.update(k8_walks(args))
        r["draws_ms"] = draw_table_ms(dev, r["pixels"], r["directions"] // 8)
        out["K8"][name] = r
        log(f"K8 split, {name}: {r['pixels']} pixels, {r['directions']} "
            f"directions, whole {r['ms']:.4f} ms ({r['event_ms']:.4f} by "
            f"events), walk {r['walk_ms']:.4f}, "
            f"to the RANSAC's end {r['ransac_end_ms']:.4f}; walks a lane "
            f"mean {r['lane_mean']:.2f} max {r['lane_max']}, a warp mean "
            f"{r['warp_mean']:.2f} max {r['warp_max']} (of "
            f"{r['probes_a_direction']}); hits {r['hits_mean']:.2f}, "
            f"RANSAC share {r['ransac_share']:.3f}; the chunk's draw table "
            f"{r['draws_ms']:.4f} ms [{card}]")
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_split needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    for name, mod in (("K7", weak_sweep), ("K8", kern)):
        built = mod.library()
        print(f"{name}: {built.path.name}", flush=True)
        for ln in built.log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  ptxas: {ln.strip()}", flush=True)
    for sa, geom in ((True, True), (True, False), (False, False)):
        info = weak_sweep.kernel_info(True, sa, geom, APD_VIEWS - 1)
        print(f"K7 u8 SA {sa} geometric {geom}: {info}", flush=True)
    print(f"K8: {kern.kernel_info('K8')}", flush=True)

    def log(m):
        print(m, flush=True)
    out = report(apd_scene(), dev, card, args.seed, log=log)
    print(json.dumps(dict(card=card, **out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
