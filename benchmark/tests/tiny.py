"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: 320 x 240
frames, 4 pyramid levels, 500 features, a small map, YOLACT at 64 px, a
short sequence and warm-up. Widths of the net are kept (only its input is
smaller)."""

from __future__ import annotations

import copy

from benchmark import harness

CAMERA = dict(fx=535.4 / 2, fy=539.2 / 2, cx=320.1 / 2, cy=247.6 / 2, width=320, height=240)


def cell(name: str) -> harness.Cell:
    c = harness.resolve(name)
    cfg = copy.deepcopy(c.config)
    s = cfg["system"]
    s["camera"].update(CAMERA)
    s["orb"].update(n_levels=4, n_features=500, max_kpts=512)
    s["map"].update(max_keyframes=32, max_points=8192, max_obs_per_kf=512)
    s["tracking"]["max_map_points_local"] = 2048
    s["dynamics"].update(max_flow_tracks=512)
    if cfg.get("segmenter"):
        cfg["segmenter"]["img_size"] = 64
    if cfg["streams"] > 2:
        cfg["streams"] = 2
    tr = copy.deepcopy(c.traffic)
    # four times the speeds, so that a frozen pose leaves the limit in a short run
    tr.update(render_frames=48, warmup_frames=24, trace_frames=2 * tr["chunk"],
              speed_m_s=4 * tr["speed_m_s"], turn_deg_s=4 * tr["turn_deg_s"])
    tr["check"].update(span=4, fast_frames=min(tr["check"]["fast_frames"], 2),
                       net_frames=min(tr["check"]["net_frames"], 2))
    return harness.Cell(name=c.name, chips=c.chips, config=cfg, traffic=tr, limits=c.limits,
                        end_to_end=c.end_to_end, per_layer=c.per_layer)
