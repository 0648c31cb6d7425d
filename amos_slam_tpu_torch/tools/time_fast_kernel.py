"""Time builds of the FAST-9 + NMS kernel against each other on one card.

    python3 -m amos_slam_tpu_torch.tools.time_fast_kernel \\
        [--baseline OLD.cu] [--variant NAME=-DFLAG=VALUE ...] [--rounds 4]

Candidates: the kernel of ``csrc/fast_margin_nms.cu`` as the package builds
it, with the level extents ("current") and without them
("current_whole_canvas"), the same source built with extra nvcc flags for
each ``--variant`` (a variant that sets one of the source's ``FMN_ABLATE_*``
switches skips a phase, to time what it costs; its output is not checked),
and ``--baseline``, a source with the first version's C
interface ``fast_margin_nms_f32(in, out, B, H, W, stream)`` (whole canvas,
no extents; e.g. an earlier revision of the file written out with git). All
are built together, each is held exactly to the plain version on the main
path's pyramid (8, 480, 640) of the synthetic room (with the level extents
where the candidate takes them), and then they are timed in turns: each
round times every candidate with ``timing.loop_ms`` (median of 5 runs of 200
held launches), in forward order on even rounds and reversed on odd ones.
For comparison with single-launch timings, each candidate is also timed
as the median of 50 single launches between two events, stream not held.
Prints ptxas's registers and shared memory per candidate, nvidia-smi's SM
clock and power before, after and under load, and one JSON line with each
candidate's median over rounds. ``--pipe-probe`` adds the rate (lanes per
clock per SM, at the highest sampled SM clock) that chains of f32 min/max,
and of f32 adds, reach on the card. Also prints how often an early-out
could skip the margin arithmetic on this input. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

import torch

from ..config import SystemConfig
from ..io import synthetic
from ..ops import fast, pyramid
from ..ops.kernels import build, timing
from ..ops.kernels import fast_margin_nms as fmn_mod


def _baseline_fn(lib_path: Path):
    fn = ctypes.CDLL(str(lib_path)).fast_margin_nms_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x):
        out = torch.empty_like(x)
        B, H, W = x.shape
        rc = fn(x.data_ptr(), out.data_ptr(), B, H, W, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline launch failed with CUDA error {rc}")
        return out

    return run


# Throughput probe: 8 + 8 cross-dependent chains of one f32 instruction per
# thread (``OP`` is fminf/fmaxf or an add), many blocks per SM.
_PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <math.h>
template <int kMinMax>
__global__ void probe(float* out, int iters, float s) {
  float a[8], b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) { a[i] = threadIdx.x * s + i; b[i] = a[i] * 0.5f + s; }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (kMinMax) {
        a[i] = fminf(a[i], b[(i + 1) & 7]);
        b[i] = fmaxf(b[i], a[(i + 3) & 7]);
      } else {
        a[i] = a[i] + b[(i + 1) & 7];
        b[i] = b[i] + a[(i + 3) & 7];
      }
    }
  }
  float r = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) r += a[i] + b[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
}
extern "C" int probe_f32(float* out, int blocks, int iters, int minmax, void* stream) {
  if (minmax) probe<1><<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters, 1e-3f);
  else probe<0><<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters, 1e-3f);
  return (int)cudaGetLastError();
}
"""


def _pipe_probe(mhz: float) -> dict:
    """Lanes per clock per SM reached by f32 min/max and by f32 add."""
    src = build.BUILD_DIR / "probe_minmax_add.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    if not src.exists() or src.read_text() != _PROBE_SRC:
        src.write_text(_PROBE_SRC)
    fn = ctypes.CDLL(str(build.build_sources([(src, ())])[0])).probe_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = sms * 8, 4096
    out = torch.empty(blocks * 256, device="cuda")
    res = {}
    call = lambda: fn(out.data_ptr(), blocks, 0, 1, torch.cuda.current_stream().cuda_stream)
    res["empty_kernel_ms"] = timing.loop_ms(call, launches=200)[0]
    for name, minmax in (("minmax", 1), ("add", 0)):
        call = lambda: fn(out.data_ptr(), blocks, iters, minmax,
                          torch.cuda.current_stream().cuda_stream)
        ms, _, _ = timing.loop_ms(call, launches=20)
        ops = blocks * 256 * iters * 16
        res[f"{name}_lanes_per_clock_per_sm"] = ops / (ms * 1e-3) / (sms * mhz * 1e6)
        res[f"{name}_ms"] = ms
    return res


def _early_out_shares(pyr: torch.Tensor, sizes) -> dict:
    """How often an early-out could skip the margin arithmetic: the share of
    the margins the active tiles compute that are 0, and the shares of
    32-margin warps (the kernel's thread order) in which every margin is 0,
    or in which the compass test (no two cyclically adjacent points of
    v[0], v[4], v[8], v[12] both above, or both below, the centre) passes
    for every pixel, which proves a margin of 0."""
    B, H, W = pyr.shape
    m = fast.fast_margin(pyr)
    p = [torch.roll(pyr, (-dy, -dx), dims=(-2, -1)) for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3))]
    up = torch.stack([torch.minimum(p[i], p[(i + 1) % 4]) for i in range(4)]).amax(0)
    down = torch.stack([torch.maximum(p[i], p[(i + 1) % 4]) for i in range(4)]).amin(0)
    compass = (up <= pyr) & (down >= pyr)
    table, n_active = fmn_mod.tile_table(sizes, H, W)
    ty, tx = -(-H // fmn_mod.TILE_H), -(-W // fmn_mod.TILE_W)
    mh, mw = fmn_mod.TILE_H + 2, fmn_mod.TILE_W + 2
    i = torch.arange(-(-mh * mw // 32) * 32, device=pyr.device)
    zero_px = n_px = zero_warps = compass_warps = n_warps = 0
    for tile in table[:n_active].tolist():
        b, rem = divmod(tile, ty * tx)
        y = (rem // tx) * fmn_mod.TILE_H - 1 + i // mw
        x = (rem % tx) * fmn_mod.TILE_W - 1 + i % mw
        h, w = sizes[b]
        need = (i < mh * mw) & (y >= 0) & (y < min(H, h + 1)) & (x >= 0) & (x < min(W, w + 1))
        yc, xc = y.clamp(0, H - 1), x.clamp(0, W - 1)
        zero = (m[b, yc, xc] == 0) | ~need
        comp = compass[b, yc, xc] | ~need
        warp_needed = need.view(-1, 32).any(1)
        n_px += int(need.sum())
        zero_px += int((zero & need).sum())
        n_warps += int(warp_needed.sum())
        zero_warps += int((zero.view(-1, 32).all(1) & warp_needed).sum())
        compass_warps += int((comp.view(-1, 32).all(1) & warp_needed).sum())
    return {"margins": n_px, "zero_margin_share": zero_px / n_px, "warps": n_warps,
            "all_zero_warp_share": zero_warps / n_warps,
            "compass_early_out_warp_share": compass_warps / n_warps}


def _ptxas_summary(lib_path: Path) -> str:
    lines = lib_path.with_suffix(".log").read_text().splitlines()
    return " | ".join(ln.split("ptxas info    : ")[-1] for ln in lines
                      if "registers" in ln or "bytes stack frame" in ln)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAG[,FLAG...], e.g. no_margin=-DFMN_ABLATE_MARGIN=1")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--launches", type=int, default=200)
    ap.add_argument("--pipe-probe", action="store_true",
                    help="also measure the f32 min/max and add issue rates")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_fast_kernel: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    jobs = [(build.source_path(fmn_mod.NAME), ())]
    names = ["current"]
    ablations = set()
    for v in args.variant:
        name, flags = v.split("=", 1)
        jobs.append((build.source_path(fmn_mod.NAME), tuple(flags.split(","))))
        names.append(name)
        if "-DFMN_ABLATE_" in flags:
            ablations.add(name)
    if args.baseline is not None:
        jobs.append((args.baseline, ()))
        names.append("baseline")
    libs = build.build_sources(jobs)
    for name, lib in zip(names, libs):
        print(f"ptxas {name} ({lib.name}): {_ptxas_summary(lib)}")

    cfg = SystemConfig()
    cam = cfg.camera
    sizes = cfg.orb.level_sizes(cam.width, cam.height)
    T = synthetic.orbit_trajectory(30, radius=0.15, advance=0.3)[0]
    gray, _ = synthetic.render(synthetic.default_room(seed=1), T)
    pyr = pyramid.build_pyramid(torch.from_numpy(gray).to(dev), sizes)
    levels = torch.tensor(sizes, dtype=torch.int32, device=dev)
    want_ext = fmn_mod.fast_margin_nms_plain(pyr, levels)
    want_full = fmn_mod.fast_margin_nms_plain(pyr)

    calls = {}
    for name, lib in zip(names, libs):
        if name == "baseline":
            run = _baseline_fn(lib)
            exact = torch.equal(run(pyr), want_full)
            calls[name] = lambda run=run: run(pyr)
        else:
            k = fmn_mod._FastMarginNMS(library=str(lib))
            exact = torch.equal(k(pyr, levels), want_ext) and torch.equal(k(pyr), want_full)
            calls[name] = lambda k=k: k(pyr, levels)
            if name == "current":
                calls["current_whole_canvas"] = lambda k=k: k(pyr)
        torch.cuda.synchronize()
        if name in ablations:
            print(f"exact {name}: {exact} (ablation, not required)")
            continue
        print(f"exact {name}: {exact}")
        if not exact:
            raise RuntimeError(f"time_fast_kernel: {name} differs from the plain version")

    early_out = _early_out_shares(pyr, sizes)
    print(f"early-out shares: {early_out}")
    query = "clocks.sm,power.draw,power.limit"
    before = timing.smi(query)
    timed = list(calls)
    per_round = {n: [] for n in timed}
    for r in range(args.rounds):
        order = timed if r % 2 == 0 else timed[::-1]
        for n in order:
            ms, _, held = timing.loop_ms(calls[n], launches=args.launches)
            per_round[n].append(ms)
            print(f"round {r} {n}: {ms:.5f} ms (runs held {held}/5)")
    single = {n: timing.loop_ms(calls[n], launches=1, runs=50, hold=False)[0]
              for n in timed}
    after = timing.smi(query)
    load = timing.smi_under_load(query, calls["current"])
    probe = None
    if args.pipe_probe:
        probe = _pipe_probe(timing.sm_mhz(load + [after]))
    print(json.dumps({
        "tool": "time_fast_kernel", "pipe_probe": probe, "early_out": early_out, "shape": list(pyr.shape),
        "device": torch.cuda.get_device_name(0),
        "name_power_limit": timing.smi("name,power.limit"),
        "smi_clocks_sm_power_draw_limit_before": before,
        "smi_clocks_sm_power_draw_limit_after": after,
        "smi_under_load_current": load,
        "median_ms": {n: statistics.median(v) for n, v in per_round.items()},
        "rounds_ms": per_round,
        "single_launch_median_ms": single,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
