"""The port's public signatures against the JAX package's: parameter names
and their order (``inspect.signature``), and plain defaults (numbers,
strings, booleans, tuples, None).

The port may add keyword-only parameters (``device``; ``sample_idx``, or
``sample_idx_f`` / ``sample_idx_h`` for the initializer's two draws, where
JAX draws with a key), and renames on purpose only what torch cannot take:
a ``jax.random`` key becomes a ``torch.Generator`` (RENAMED). Covered: the
System and Segmenter entry points, the public functions, classes and
methods of the loop-closing modules, the stereo / monocular modules, the
dataset loaders, multistream SLAM, map checkpoints, the viewer, the native
loader, the real-imagery replay and YOLACT's configs, data pipeline,
training and eval, with the fields of their NamedTuples.
"""

import importlib
import inspect

import pytest

RENAMED = {"key": "generator"}
PLAIN = (int, float, bool, str, tuple, type(None))

SYSTEM = ["__init__", "track_rgbd", "track_rgbd_chunk", "save_trajectory_tum",
          "save_trajectory_kitti", "save_keyframe_trajectory_tum", "corrected_poses_np",
          "global_refine", "shutdown", "reset", "poses_np", "activate_localization_mode",
          "deactivate_localization_mode", "track_stereo", "track_monocular", "save_map",
          "load_map"]
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
    + [("ops.stereo", "match_stereo"), ("geometry.camera", "project_stereo"),
       ("solvers.fundamental", "ransac_fundamental"),
       ("solvers.initializer", "initialize_two_view"),
       ("frontend.tracking", "fused_stereo_step"), ("frontend.tracking", "fused_mono_step")]
    + [("io.tum", n) for n in ("TumRGBDDataset.__init__", "load_associations", "associate",
                               "rgb_to_gray")]
    + [("io.kitti", n) for n in ("KittiStereoDataset.__init__", "kitti_camera_config")]
    + [("io.euroc", n) for n in ("EurocMonoDataset.__init__", "euroc_camera_config")]
    + [("parallel.multistream", n) for n in (
        "make_stream_mesh", "empty_views", "init_state", "multistream_step", "shard_step",
        "MultiStreamSLAM.__init__", "MultiStreamSLAM.initialize", "MultiStreamSLAM.step",
        "MultiStreamSLAM.flush", "MultiStreamSLAM._refresh_views",
        "MultiStreamSLAM._resolve_step", "MultiStreamSLAM._insert_keyframes")]
    + [("slam_map.checkpoint", n) for n in ("save_map", "load_map")]
    + [("viewer", n) for n in ("save_ply", "dump_map", "plot_topdown", "draw_frame")]
    + [("io.native_loader", n) for n in ("available", "decode_png",
                                         "NativePrefetchLoader.__init__")]
    + [("io.warp_replay", n) for n in ("plane_replay_frame", "plane_replay_sequence",
                                       "load_reference_frame", "load_reference_frames",
                                       "real_room", "real_room_with_mover")]
    + [("models.configs", n) for n in ("YolactConfig.build", "YolactConfig.priors", "register",
                                       "get_config")]
    + [("models.data", n) for n in (
        "decode_uncompressed_rle", "decode_compressed_rle", "polygons_to_mask",
        "annotation_to_mask", "CocoDataset.__init__", "SyntheticShapes.__init__",
        "augment_sample", "samples_to_gt_batch", "DataLoader.__init__", "DataLoader.stop")]
    + [("models.train", n) for n in ("multibox_loss", "make_train_step")]
    + [("models.eval", n) for n in ("box_iou", "mask_iou", "average_precision",
                                    "evaluate_detections")]
)
TUPLES = [("geometry.sim3", "Sim3"), ("loop.vocabulary", "Vocabulary"),
          ("solvers.sim3_solver", "Sim3RansacResult"), ("solvers.sim3_solver", "Sim3OptResult"),
          ("solvers.pose_graph", "PoseGraphProblem"), ("solvers.pose_graph", "PoseGraphResult"),
          ("ops.stereo", "StereoMatchResult"), ("solvers.fundamental", "FundamentalResult"),
          ("solvers.initializer", "InitResult"), ("parallel.multistream", "StreamState"),
          ("models.train", "GTBatch"), ("models.train", "TrainState")]


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
    assert set(t_kw) <= {"device", "sample_idx", "sample_idx_f", "sample_idx_h"}, t_kw
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
