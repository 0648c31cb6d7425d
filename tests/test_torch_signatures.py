"""The port's public signatures against the JAX package's: parameter names
and their order (``inspect.signature``), and plain defaults (numbers,
strings, booleans, tuples, None).

The port may add keyword-only parameters (``device``; ``sample_idx`` where
JAX draws with a key), and renames on purpose only what torch cannot take:
a ``jax.random`` key becomes a ``torch.Generator`` (RENAMED). Covered: the
System and Segmenter entry points, and the public functions, classes and
methods of the loop-closing modules, with the fields of their NamedTuples.
"""

import importlib
import inspect

import pytest

RENAMED = {"key": "generator"}
PLAIN = (int, float, bool, str, tuple, type(None))

SYSTEM = ["__init__", "track_rgbd", "track_rgbd_chunk", "save_trajectory_tum",
          "save_trajectory_kitti", "save_keyframe_trajectory_tum", "corrected_poses_np",
          "global_refine", "shutdown", "reset", "poses_np", "activate_localization_mode",
          "deactivate_localization_mode"]
CALLABLES = (
    [("system", f"System.{m}") for m in SYSTEM]
    + [("models.segmenter", f"Segmenter.{m}")
       for m in ("__init__", "person_mask", "person_mask_batch")]
    + [("geometry.sim3", n) for n in ("sim3_exp", "sim3_log", "Sim3.apply", "Sim3.compose",
                                      "Sim3.inverse", "Sim3.identity", "Sim3.from_se3")]
    + [("loop.vocabulary", n) for n in ("train_vocabulary", "transform", "bow_vector",
                                        "l1_score")]
    + [("loop.vocab_io", n) for n in ("save_npz", "load_npz", "load_orbvoc_txt")]
    + [("loop.kf_database", f"KeyFrameDatabase.{m}")
       for m in ("__init__", "add", "erase", "remap", "score", "query")]
    + [("solvers.sim3_solver", n) for n in ("horn_sim3", "ransac_sim3", "optimize_sim3")]
    + [("solvers.pose_graph", "optimize_pose_graph"),
       ("solvers.structure_only", "refine_points")]
    + [("loop.loop_closing", f"LoopCloser.{m}")
       for m in ("__init__", "bow_dispatch", "on_keyframe", "on_keyframe_resolve",
                 "remap_slots", "flush_gba", "relocalize")]
    + [("loop.global_ba", n) for n in (
        "GlobalBundleAdjustment.__init__", "GlobalBundleAdjustment.step",
        "GlobalBundleAdjustment.abort", "GlobalBundleAdjustment.finish",
        "GlobalBundleAdjustment.run", "harvest_observations", "run_global_refinement")]
)
TUPLES = [("geometry.sim3", "Sim3"), ("loop.vocabulary", "Vocabulary"),
          ("solvers.sim3_solver", "Sim3RansacResult"), ("solvers.sim3_solver", "Sim3OptResult"),
          ("solvers.pose_graph", "PoseGraphProblem"), ("solvers.pose_graph", "PoseGraphResult")]


def resolve(package, module, dotted):
    obj = importlib.import_module(f"{package}.{module}")
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def params(fn):
    """(positional-or-keyword names, keyword-only names, plain defaults)."""
    sig = inspect.signature(fn)
    pos = [p.name for p in sig.parameters.values()
           if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    kw = [p.name for p in sig.parameters.values() if p.kind is p.KEYWORD_ONLY]
    plain = {p.name: p.default for p in sig.parameters.values()
             if p.default is not p.empty and isinstance(p.default, PLAIN)}
    return pos, kw, plain


@pytest.mark.parametrize("module,name", CALLABLES, ids=lambda x: x)
def test_signature_matches_jax(module, name):
    j_pos, j_kw, j_plain = params(resolve("amos_slam_tpu", module, name))
    t_pos, t_kw, t_plain = params(resolve("amos_slam_tpu_torch", module, name))
    assert t_pos == [RENAMED.get(n, n) for n in j_pos], (t_pos, j_pos)
    assert not j_kw, j_kw
    assert set(t_kw) <= {"device", "sample_idx"}, t_kw
    for n, v in j_plain.items():
        n = RENAMED.get(n, n)
        if n in t_plain:
            assert t_plain[n] == v, (n, t_plain[n], v)


@pytest.mark.parametrize("module,name", TUPLES, ids=lambda x: x)
def test_namedtuple_fields_match_jax(module, name):
    assert (resolve("amos_slam_tpu_torch", module, name)._fields
            == resolve("amos_slam_tpu", module, name)._fields)


def test_positional_calls_mean_the_same():
    """The faults this test pins: System(cfg, vocabulary) and
    Segmenter(params, generator, num_classes) take their second and third
    arguments as JAX does, and ``device`` only by keyword."""
    from amos_slam_tpu_torch.models.segmenter import Segmenter
    from amos_slam_tpu_torch.system import System

    s = inspect.signature(System.__init__)
    assert list(s.parameters)[1:4] == ["cfg", "vocabulary", "debug_dir"]
    assert s.parameters["device"].kind is inspect.Parameter.KEYWORD_ONLY
    g = inspect.signature(Segmenter.__init__)
    assert list(g.parameters)[1:4] == ["params", "generator", "num_classes"]
    assert g.parameters["device"].kind is inspect.Parameter.KEYWORD_ONLY
