"""GeoLLM-Engine platform tools (beyond the two dCache tools).

Pure functions over ``GeoFrame`` values registered as :class:`ToolSpec`;
the agent resolves ``$var`` references from its variable environment before
dispatch, mirroring function-calling with object handles. Latencies are
charged per call via the SimClock (``tool_op_s``); the heavy ML tools
carry larger constants.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.agent.geollm.datastore import (
    CLASSES,
    LAND_COVERS,
    REGIONS,
    GeoFrame,
)
from repro_torch.core.tools import ToolError, ToolSpec


def _require_frame(f):
    if not isinstance(f, GeoFrame):
        raise ToolError(f"expected a GeoFrame handle, got {type(f).__name__}")
    return f


def filter_bbox(frame, region: str) -> GeoFrame:
    f = _require_frame(frame)
    if region not in REGIONS:
        raise ToolError(f"unknown region {region!r}; known: {sorted(REGIONS)}")
    return f.filter_bbox(REGIONS[region])


def filter_class(frame, class_name: str) -> GeoFrame:
    f = _require_frame(frame)
    if class_name not in CLASSES:
        raise ToolError(f"unknown class {class_name!r}")
    return f.filter_class(class_name)


def filter_clouds(frame, max_pct: float) -> GeoFrame:
    return _require_frame(frame).filter_clouds(float(max_pct))


def filter_date_range(frame, start_month: int, end_month: int) -> GeoFrame:
    f = _require_frame(frame)
    m0, m1 = int(start_month), int(end_month)

    def compute():
        month = ((f.timestamp // (30 * 24 * 3600)) % 12) + 1
        return f._mask((month >= m0) & (month <= m1))

    return f.memo_op(("date_range", m0, m1), compute)


def count_images(frame) -> int:
    return len(_require_frame(frame))


def detect_objects(frame, class_name: str) -> Dict:
    """Object detection over the (already filtered) tile set."""
    f = _require_frame(frame)
    if class_name not in CLASSES:
        raise ToolError(f"unknown class {class_name!r}")

    def compute():
        sub = f.filter_class(class_name)
        return {"class": class_name, "images": len(sub),
                "detections": int(sub.det_count.sum())}

    return dict(f.memo_op(("detect", class_name), compute))


def land_cover_stats(frame) -> Dict[str, float]:
    f = _require_frame(frame)

    def compute():
        if len(f) == 0:
            return {c: 0.0 for c in LAND_COVERS}
        counts = np.bincount(f.land_cover, minlength=len(LAND_COVERS))
        return {c: float(counts[i]) / len(f)
                for i, c in enumerate(LAND_COVERS)}

    return dict(f.memo_op(("lcc_stats",), compute))


def dominant_land_covers(frame, top_k: int = 2) -> List[str]:
    f = _require_frame(frame)
    k = int(top_k)

    def compute():
        stats = land_cover_stats(f)
        return sorted(stats, key=stats.get, reverse=True)[:k]

    return list(f.memo_op(("lcc_top", k), compute))


def vqa_answer(frame, question: str) -> str:
    """Template VQA over frame statistics (deterministic)."""
    f = _require_frame(frame)

    def compute():
        n = len(f)
        dets = int(f.det_count.sum())
        covers = dominant_land_covers(f, 2)
        cloudy = float((f.cloud_pct > 50).mean()) if n else 0.0
        return (f"the region contains {n} images with {dets} detected "
                f"objects ; dominant land cover is {covers[0]} followed by "
                f"{covers[1]} ; {cloudy:.0%} of scenes are cloudy")

    return f.memo_op(("vqa",), compute)


def image_stats(frame) -> Dict:
    f = _require_frame(frame)
    return {"images": len(f),
            "mean_cloud_pct": float(f.cloud_pct.mean()) if len(f) else 0.0,
            "detections": int(f.det_count.sum())}


def sample_images(frame, k: int = 5) -> List[str]:
    f = _require_frame(frame)
    return list(f.filename[: int(k)])


def sort_by_time(frame) -> GeoFrame:
    f = _require_frame(frame)
    return f.memo_op(
        ("sort_time",),
        lambda: f._take(np.argsort(f.timestamp, kind="stable")))


def merge_frames(frame_a, frame_b) -> GeoFrame:
    a, b = _require_frame(frame_a), _require_frame(frame_b)
    return GeoFrame(
        f"{a.key}+{b.key}",
        np.concatenate([a.filename, b.filename]),
        np.concatenate([a.lon, b.lon]), np.concatenate([a.lat, b.lat]),
        np.concatenate([a.timestamp, b.timestamp]),
        np.concatenate([a.class_id, b.class_id]),
        np.concatenate([a.det_count, b.det_count]),
        np.concatenate([a.land_cover, b.land_cover]),
        np.concatenate([a.cloud_pct, b.cloud_pct]))


def plot_images(frame) -> str:
    f = _require_frame(frame)
    return f"<map-layer images={len(f)} src={f.key}>"


def plot_heatmap(frame, value: str = "detections") -> str:
    f = _require_frame(frame)
    return f"<heatmap value={value} n={len(f)}>"


def timeseries(frame, freq: str = "month") -> List[int]:
    f = _require_frame(frame)

    def compute():
        if len(f) == 0:
            return []
        month = ((f.timestamp // (30 * 24 * 3600)) % 12).astype(int)
        return np.bincount(month, minlength=12).tolist()

    return list(f.memo_op(("timeseries", freq), compute))


_ML_LATENCY = 0.12   # detector / classifier endpoints
_UI_LATENCY = 0.05


def make_geo_tools(clock) -> List[ToolSpec]:
    op = clock.latency.tool_op_s
    str_p = {"type": "string"}
    num_p = {"type": "number"}

    def spec(name, fn, desc, params, latency):
        return ToolSpec(name=name, description=desc, parameters=params,
                        fn=fn, latency_s=latency)

    return [
        spec("filter_bbox", filter_bbox,
             "Filter a frame to a named region of interest.",
             {"frame": str_p, "region": str_p}, op),
        spec("filter_class", filter_class,
             "Keep only images whose dominant class matches.",
             {"frame": str_p, "class_name": str_p}, op),
        spec("filter_clouds", filter_clouds,
             "Keep images with cloud cover below a threshold.",
             {"frame": str_p, "max_pct": num_p}, op),
        spec("filter_date_range", filter_date_range,
             "Keep images within [start_month, end_month].",
             {"frame": str_p, "start_month": num_p, "end_month": num_p}, op),
        spec("count_images", count_images, "Number of images in a frame.",
             {"frame": str_p}, op),
        spec("detect_objects", detect_objects,
             "Run the object detector for one class over a frame.",
             {"frame": str_p, "class_name": str_p}, _ML_LATENCY),
        spec("land_cover_stats", land_cover_stats,
             "Land-cover distribution of a frame.", {"frame": str_p},
             _ML_LATENCY),
        spec("dominant_land_covers", dominant_land_covers,
             "Top-k land covers of a frame.",
             {"frame": str_p, "top_k": num_p}, _ML_LATENCY),
        spec("vqa_answer", vqa_answer,
             "Answer a free-form question about a frame.",
             {"frame": str_p, "question": str_p}, _ML_LATENCY),
        spec("image_stats", image_stats, "Summary statistics of a frame.",
             {"frame": str_p}, op),
        spec("sample_images", sample_images, "Sample k image filenames.",
             {"frame": str_p, "k": num_p}, op),
        spec("sort_by_time", sort_by_time, "Sort a frame by timestamp.",
             {"frame": str_p}, op),
        spec("merge_frames", merge_frames, "Concatenate two frames.",
             {"frame_a": str_p, "frame_b": str_p}, op),
        spec("plot_images", plot_images, "Render frame tiles on the map UI.",
             {"frame": str_p}, _UI_LATENCY),
        spec("plot_heatmap", plot_heatmap, "Render a heatmap layer.",
             {"frame": str_p, "value": str_p}, _UI_LATENCY),
        spec("timeseries", timeseries, "Monthly acquisition counts.",
             {"frame": str_p, "freq": str_p}, op),
    ]
