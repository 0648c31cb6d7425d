"""Time builds of the FAST-9 + NMS kernels against each other on one card.

    python3 -m amos_slam_tpu_torch.tools.time_fast_kernel \\
        [--streams 1 4 8] [--kitti] [--baseline OLD.cu [--ablate-baseline]] \\
        [--variant NAME=-DFLAG=VALUE ...] [--rounds 4] [--pipe-probe]

Shapes: for each S of ``--streams``, (S * 8, 480, 640), the pyramids of S
synthetic rooms (the multistream phase's, one frame each) with the level
extents of ``ORBConfig.level_sizes`` repeated S times: S = 1 is the single
route's shape, 8 multistream's, 4 a mesh group's; ``--kitti`` adds
(8, 376, 1241) with KITTI's level extents. Candidates: the kernels of
``csrc/fast_margin_nms.cu`` as the package builds them, once with each
kernel forced ("tiles", "persistent"; the package takes the one ``route``
picks by shape, printed per shape); the same source built with extra nvcc
flags for each ``--variant``, routed by shape (the source's variant
switches: an ``FMN_ABLATE_*`` one skips a phase, to time what it costs,
and its output is not checked); and ``--baseline``, another source with
the tiles kernel's C interface ``fast_margin_nms_tiles_f32`` (an earlier
revision written out with git: ``git show REV:amos_slam_tpu_torch/csrc/
fast_margin_nms.cu > old.cu``), with ``--ablate-baseline`` also built with
each ablation variant's flags. All are built together, each is held
exactly to the plain version at every shape, and then they are timed in
turns: each round times every (shape, candidate) with ``timing.loop_ms``
(median of 5 runs of 200 held launches), in forward order on even rounds
and reversed on odd ones. Prints ptxas's registers and shared memory per
build, nvidia-smi's SM clock and power before, after and under load, and
one JSON line with each candidate's median over rounds per shape, beside
the shape's bytes bound, its margin count and, for reference, the time of
torch's fill of the output and copy of the input. ``--pipe-probe`` adds
the issue rate (lanes per clock per SM, at the highest sampled SM clock)
of each instruction the kernels reduce with (``csrc/pipe_probe.cu``: f32
min/max and add, int32 min/max, the DPX three-input min/max and relu max),
the SASS opcodes each compiles to (cuobjdump), and each route's issue
floor per shape. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..config import ORBConfig
from ..io import synthetic
from ..ops import pyramid
from ..ops.kernels import build, timing
from ..ops.kernels import fast_margin_nms as fmn_mod

PROBE = "pipe_probe"
# csrc/pipe_probe.cu's operations, by index
PROBE_OPS = ("f32_minmax", "f32_add", "i32_minmax", "vimin3_s32", "vimax3_s32",
             "vimax3_s32_relu", "vimax_s32_relu")


def _sass_opcodes(lib_path: Path) -> dict:
    """{probe op: {SASS opcode: count}} of each probe<OP> kernel."""
    from torch.utils.cpp_extension import CUDA_HOME

    res = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True, timeout=120)
    out, op = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : \S*probeILi(\d+)E", line)
        if m:
            op = PROBE_OPS[int(m.group(1))]
            out[op] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if op is not None and m:
            out[op][m.group(1)] += 1
    return {k: dict(v.most_common(6)) for k, v in out.items()}


def pipe_rates(mhz: float) -> dict:
    """Lanes per clock per SM that chains of each probe operation reach on
    the current card at ``mhz`` SM clock, and the SASS opcodes of each."""
    lib_path = build.library_path(PROBE)
    fn = build.load(PROBE).pipe_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = sms * 8, 4096
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")

    def call(op, n):
        rc = fn(out.data_ptr(), blocks, n, op, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"pipe probe launch failed with CUDA error {rc}")

    res = {"empty_kernel_ms": timing.loop_ms(lambda: call(0, 0), launches=200)[0],
           "sm_mhz": mhz, "lanes_per_clock_per_sm": {}, "ms": {}}
    for op, name in enumerate(PROBE_OPS):
        ms = timing.loop_ms(lambda: call(op, iters), launches=20)[0]
        res["ms"][name] = ms
        res["lanes_per_clock_per_sm"][name] = (
            blocks * 256 * iters * 16 / (ms * 1e-3) / (sms * mhz * 1e6))
    res["sass_opcodes"] = _sass_opcodes(lib_path)
    return res


def issue_floor_ms(route: str, margins: int, rates: dict, mhz: float, sms: int) -> float:
    """Least time of the route's min/max instructions for ``margins`` at the
    probed rates: sum over instructions of count x margins / (rate x SMs x
    SM clock)."""
    return sum(n * margins / (rates[op] * sms * mhz * 1e6)
               for op, n in fmn_mod.MINMAX_PER_MARGIN[route].items()) * 1e3


def _ptxas_summary(lib_path: Path) -> str:
    lines = lib_path.with_suffix(".log").read_text().splitlines()
    return " | ".join(ln.split("ptxas info    : ")[-1] for ln in lines
                      if "registers" in ln or "bytes stack frame" in ln)


def _shapes(streams, kitti: bool, dev) -> dict:
    """label -> (pyramids (B, H, W), extents (B, 2) int32, level sizes x S)."""
    orb = ORBConfig()
    sizes = orb.level_sizes(640, 480)
    poses = synthetic.orbit_trajectory(144, radius=0.1, advance=144 / 768)[:1]
    n = max(streams)
    rooms = [synthetic.default_room(seed=20 + s) for s in range(n)]
    gray = np.stack([np.clip(g, 0, 255).astype(np.uint8).astype(np.float32) for g, _ in
                     synthetic.render_rooms(rooms, poses, min(n, os.cpu_count() or 1))[0]])
    pyrs = torch.stack([pyramid.build_pyramid(g, sizes) for g in torch.from_numpy(gray).to(dev)])
    shapes = {}
    for S in streams:
        hw = list(sizes) * S
        shapes[f"{S * 8}x480x640"] = (pyrs[:S].reshape(S * 8, 480, 640).contiguous(),
                                      torch.tensor(hw, dtype=torch.int32, device=dev), hw)
    if kitti:
        from ..io.kitti import kitti_camera_config

        kcam = kitti_camera_config(0)
        ksizes = orb.level_sizes(kcam.width, kcam.height)
        T = synthetic.orbit_trajectory(30, radius=0.15, advance=0.3)[0]
        kgray = synthetic.render(synthetic.default_room(seed=1), T, fx=kcam.fx, fy=kcam.fy,
                                 cx=kcam.cx, cy=kcam.cy, width=kcam.width,
                                 height=kcam.height)[0]
        kpyr = pyramid.build_pyramid(torch.from_numpy(kgray).to(dev), ksizes)
        shapes[f"8x{kcam.height}x{kcam.width}_kitti"] = (
            kpyr, torch.tensor(ksizes, dtype=torch.int32, device=dev), list(ksizes))
    return shapes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, nargs="+", default=[1])
    ap.add_argument("--kitti", action="store_true")
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--ablate-baseline", action="store_true",
                    help="also build the baseline with each ablation variant's flags")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAG[,FLAG...], e.g. no_margin=-DFMN_ABLATE_MARGIN=1")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--launches", type=int, default=200)
    ap.add_argument("--pipe-probe", action="store_true",
                    help="also measure the issue rates of the reduction's instructions")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_fast_kernel: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    src = build.source_path(fmn_mod.NAME)
    jobs, names = [(src, ())], ["current"]
    ablations = set()
    variants = [v.split("=", 1) for v in args.variant]
    for name, flags in variants:
        jobs.append((src, tuple(flags.split(","))))
        names.append(name)
    if args.baseline is not None:
        jobs.append((args.baseline, ()))
        names.append("baseline")
        if args.ablate_baseline:
            for name, flags in variants:
                if "-DFMN_ABLATE_" not in flags:
                    continue
                jobs.append((args.baseline, tuple(flags.split(","))))
                names.append(f"baseline_{name}")
    for name, (_, flags) in zip(names, jobs):
        if any("-DFMN_ABLATE_" in f for f in flags):
            ablations.add(name)
    if args.pipe_probe:   # built beside the candidates
        jobs.append((build.source_path(PROBE), ()))
    libs = build.build_sources(jobs)[: len(names)]
    for name, lib in zip(names, libs):
        print(f"ptxas {name} ({lib.name}): {_ptxas_summary(lib)}")

    kernels = {}
    for name, lib in zip(names, libs):
        if name == "current":
            for force in fmn_mod.ROUTES:
                kernels[force] = fmn_mod._FastMarginNMS(library=str(lib), force=force)
        else:
            kernels[name] = fmn_mod._FastMarginNMS(library=str(lib))
    shapes = _shapes(args.streams, args.kitti, dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    package = fmn_mod._FastMarginNMS(library=str(libs[0]))
    info = {}
    for label, (pyr, ext, hw) in shapes.items():
        want = fmn_mod.fast_margin_nms_plain(pyr, ext)
        B, H, W = pyr.shape
        table, n_active = fmn_mod.tile_table(hw, H, W)
        read = sum(h * w for h, w in hw)
        bound_ms, by = timing.bound(4 * read, 4 * pyr.numel(), fmn_mod.OPS_PER_PIXEL * read)
        info[label] = {"shape": [B, H, W], "active_tiles": n_active, "tiles": int(table.size),
                       "wave": package.wave(dev), "route": package.route_of(n_active, dev),
                       "read_px": read, "write_px": pyr.numel(),
                       "margins": fmn_mod.margins_computed(hw, H, W),
                       "bound_ms": bound_ms, "bound_by": by}
        for name, k in kernels.items():
            exact = torch.equal(k(pyr, ext), want)
            torch.cuda.synchronize()
            tag = " (ablation, not required)" if name in ablations else ""
            print(f"exact {label} {name}: {exact}{tag}")
            if not exact and name not in ablations:
                raise RuntimeError(f"time_fast_kernel: {name} differs from the plain "
                                   f"version at {label}")
    print(f"shapes: {json.dumps(info)}")

    query = "clocks.sm,power.draw,power.limit"
    before = timing.smi(query)
    timed = [(label, name) for label in shapes for name in kernels]
    per_round = {lab: {n: [] for n in kernels} for lab in shapes}
    for r in range(args.rounds):
        for label, name in (timed if r % 2 == 0 else timed[::-1]):
            pyr, ext, _ = shapes[label]
            k = kernels[name]
            ms, _, held = timing.loop_ms(lambda: k(pyr, ext), launches=args.launches)
            per_round[label][name].append(ms)
            print(f"round {r} {label} {name}: {ms:.5f} ms (runs held {held}/5)")
    after = timing.smi(query)
    first = next(iter(shapes))
    load = timing.smi_under_load(query, lambda: kernels["persistent"](*shapes[first][:2]))
    probe = None
    if args.pipe_probe:
        probe = pipe_rates(timing.sm_mhz(load + [after]))
        rates = probe["lanes_per_clock_per_sm"]
        for label in shapes:
            info[label]["issue_floor_ms"] = {
                route: issue_floor_ms(route, info[label]["margins"], rates,
                                      probe["sm_mhz"], sms) for route in fmn_mod.ROUTES}
    for label, (pyr, _, _) in shapes.items():
        out = torch.empty_like(pyr)   # what the memory alone allows, for reference
        info[label]["torch_fill_ms"] = timing.loop_ms(out.zero_, launches=args.launches)[0]
        info[label]["torch_copy_ms"] = timing.loop_ms(lambda: out.copy_(pyr),
                                                      launches=args.launches)[0]
        info[label]["median_ms"] = {n: statistics.median(v)
                                    for n, v in per_round[label].items()}
        info[label]["rounds_ms"] = per_round[label]
    print(json.dumps({
        "tool": "time_fast_kernel", "device": torch.cuda.get_device_name(0),
        "name_power_limit": timing.smi("name,power.limit"), "sms": sms,
        "smi_clocks_sm_power_draw_limit_before": before,
        "smi_clocks_sm_power_draw_limit_after": after,
        "smi_under_load_persistent": load,
        "pipe_probe": probe, "shapes": info,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
