"""Synthetic geospatial catalog: the "main memory" of the paper.

``GeoFrame`` is a small columnar frame (numpy-backed; GeoPandas is not
available offline — DESIGN §9) holding per-image metadata: filenames,
coordinates, detections, timestamps. ``GeoDataStore`` lazily materialises a
deterministic frame per ``dataset-year`` key (~15k rows each across 8
datasets x 9 years ~= 1.1M images, matching GeoLLM-Engine's catalog scale)
and charges DB-load latency to the SimClock; cache reads are 5-10x cheaper.

Performance model (this file is the data plane's hot path):

* Filters return **lazy index views**: a view shares the parent's base
  column arrays and holds only an int index into them. Columns gather on
  first access (and memoise per view), so a ``detect`` step that touches
  two of the nine columns never pays for the other seven. Values are
  bit-identical to the old copy-all-columns implementation.
* ``filter_bbox`` results are memoised per (frame, bbox). Root frames are
  shared process-wide (see below), so the datastore effectively memoises
  per (key, region) — the workload's universally-first filter.
* Root frames are immutable and deterministic, so ``synth_frame`` keeps a
  process-wide memo shared by every ``GeoDataStore`` (benchmark cells stop
  re-synthesising the same 72 frames per cell).
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Optional

import numpy as np

DATASETS = ("xview1", "fair1m", "dota", "spacenet", "landsat",
            "sentinel2", "naip", "modis")
YEARS = tuple(range(2015, 2024))
CLASSES = ("airplane", "ship", "vehicle", "building", "storage_tank",
           "harbor", "bridge", "helicopter")
LAND_COVERS = ("urban", "forest", "water", "cropland", "barren", "wetland")
REGIONS = {
    "newport beach": (-117.95, 33.57, -117.85, 33.65),
    "san francisco": (-122.52, 37.70, -122.35, 37.83),
    "houston": (-95.55, 29.60, -95.20, 29.90),
    "miami": (-80.35, 25.70, -80.10, 25.90),
    "seattle": (-122.45, 47.50, -122.20, 47.70),
    "denver": (-105.10, 39.60, -104.80, 39.85),
}

COLUMNS = ("filename", "lon", "lat", "timestamp", "class_id", "det_count",
           "land_cover", "cloud_pct")


def all_keys() -> List[str]:
    return [f"{d}-{y}" for d in DATASETS for y in YEARS]


_ALL_KEYS = frozenset(all_keys())


class GeoFrame:
    """Columnar per-image metadata for one dataset-year.

    Construct with full column arrays (a *root* frame). Filters and sorts
    return index views over the root's columns; views are immutable and may
    be shared between callers (the bbox memo relies on this).
    """

    __slots__ = ("key", "_base", "_index", "_cols", "_bbox_memo", "_op_memo")

    def __init__(self, key: str, filename: np.ndarray, lon: np.ndarray,
                 lat: np.ndarray, timestamp: np.ndarray,
                 class_id: np.ndarray, det_count: np.ndarray,
                 land_cover: np.ndarray, cloud_pct: np.ndarray):
        self.key = key
        self._base = {"filename": filename, "lon": lon, "lat": lat,
                      "timestamp": timestamp, "class_id": class_id,
                      "det_count": det_count, "land_cover": land_cover,
                      "cloud_pct": cloud_pct}
        self._index: Optional[np.ndarray] = None   # None -> root frame
        self._cols: Dict[str, np.ndarray] = {}
        self._bbox_memo: Dict[tuple, "GeoFrame"] = {}
        self._op_memo: Dict[tuple, object] = {}

    # -- lazy columns --------------------------------------------------------
    def _col(self, name: str) -> np.ndarray:
        if self._index is None:
            return self._base[name]
        c = self._cols.get(name)
        if c is None:
            c = self._base[name][self._index]
            self._cols[name] = c
        return c

    @property
    def filename(self) -> np.ndarray:
        return self._col("filename")

    @property
    def lon(self) -> np.ndarray:
        return self._col("lon")

    @property
    def lat(self) -> np.ndarray:
        return self._col("lat")

    @property
    def timestamp(self) -> np.ndarray:
        return self._col("timestamp")

    @property
    def class_id(self) -> np.ndarray:
        return self._col("class_id")

    @property
    def det_count(self) -> np.ndarray:
        return self._col("det_count")

    @property
    def land_cover(self) -> np.ndarray:
        return self._col("land_cover")

    @property
    def cloud_pct(self) -> np.ndarray:
        return self._col("cloud_pct")

    def __len__(self) -> int:
        if self._index is not None:
            return len(self._index)
        return len(self._base["lon"])

    @property
    def size_bytes(self) -> int:
        # model the paper's 50-100 MB per yearly frame
        return int(len(self) * 5200)

    @property
    def size_mb(self) -> float:
        return self.size_bytes / 1e6

    # -- views ---------------------------------------------------------------
    def _take(self, idx: np.ndarray) -> "GeoFrame":
        """Index view: idx positions are relative to *this* frame."""
        view = object.__new__(GeoFrame)
        view.key = self.key
        view._base = self._base
        view._index = idx if self._index is None else self._index[idx]
        view._cols = {}
        view._bbox_memo = {}
        view._op_memo = {}
        return view

    def memo_op(self, op_key: tuple, fn):
        """Memoise a deterministic pure operation on this (immutable) frame.

        Filters, sorts and aggregations over a frame are pure functions of
        its contents, and the bbox memo already shares ROI views across
        every consumer of a root frame — so memoising per (view, op, args)
        makes the whole benchmark grid share one physical execution of each
        distinct tool computation (the gold executor and every benchmark
        cell replay the same plans). Callers that return mutable containers
        copy on the way out; frame results are immutable shared views."""
        hit = self._op_memo.get(op_key)
        if hit is None:
            hit = self._op_memo[op_key] = fn()
        return hit

    def _mask(self, m: np.ndarray) -> "GeoFrame":
        return self._take(np.flatnonzero(m))

    def filter_bbox(self, bbox) -> "GeoFrame":
        bbox = tuple(bbox)
        hit = self._bbox_memo.get(bbox)
        if hit is None:
            x0, y0, x1, y1 = bbox
            lon, lat = self.lon, self.lat
            m = (lon >= x0) & (lon <= x1) & (lat >= y0) & (lat <= y1)
            hit = self._mask(m)
            self._bbox_memo[bbox] = hit
        return hit

    def filter_class(self, class_name: str) -> "GeoFrame":
        return self.memo_op(
            ("class", class_name),
            lambda: self._mask(self.class_id == CLASSES.index(class_name)))

    def filter_clouds(self, max_pct: float) -> "GeoFrame":
        return self.memo_op(
            ("clouds", max_pct),
            lambda: self._mask(self.cloud_pct <= max_pct))


def _seed_for(key: str) -> int:
    return int.from_bytes(hashlib.blake2b(key.encode(),
                                          digest_size=4).digest(), "big")


def _filenames(dataset: str, year: str, n: int) -> np.ndarray:
    """``{dataset}_{year}_%06d.tif`` for 0..n-1, built as raw UCS4 code
    points and viewed as a unicode array — element-for-element identical to
    ``np.char.mod`` but ~30x faster (the per-element C format loop was the
    single largest cost of synthesising a root frame)."""
    prefix = f"{dataset}_{year}_"
    suffix = ".tif"
    assert n < 10 ** 6            # %06d: six digits always
    width = len(prefix) + 6 + len(suffix)
    codes = np.empty((n, width), dtype=np.uint32)
    codes[:, :len(prefix)] = np.frombuffer(
        prefix.encode("utf-32-le"), dtype=np.uint32)
    digits = np.arange(n, dtype=np.int64)
    for j in range(5, -1, -1):
        codes[:, len(prefix) + j] = 48 + digits % 10      # ord('0') == 48
        digits //= 10
    codes[:, len(prefix) + 6:] = np.frombuffer(
        suffix.encode("utf-32-le"), dtype=np.uint32)
    return codes.view(f"<U{width}").ravel()


# process-wide root-frame memo: synth_frame is deterministic and frames are
# immutable, so every datastore/benchmark cell can share one instance per
# (key, rows_range) — the default band and the widened cost-ablation band
# coexist without collision
_FRAME_MEMO: Dict[tuple, GeoFrame] = {}

DEFAULT_ROWS_RANGE = (12_000, 18_000)   # ~62-94 MB at 5200 B/row


def synth_frame(key: str, rows_range: Optional[tuple] = None) -> GeoFrame:
    memo_key = (key, rows_range)
    cached = _FRAME_MEMO.get(memo_key)
    if cached is not None:
        return cached
    rng = np.random.default_rng(_seed_for(key))
    dataset, year = key.rsplit("-", 1)
    lo, hi = rows_range or DEFAULT_ROWS_RANGE
    n = int(rng.integers(lo, hi))
    # spatially skewed around regions of interest (the paper's observation)
    centers = np.array([[(b[0] + b[2]) / 2, (b[1] + b[3]) / 2]
                        for b in REGIONS.values()])
    which = rng.integers(0, len(centers), n)
    lon = (centers[which, 0] + rng.normal(0, 0.15, n)).astype(np.float32)
    lat = (centers[which, 1] + rng.normal(0, 0.12, n)).astype(np.float32)
    t0 = np.datetime64(f"{year}-01-01").astype("datetime64[s]").astype(np.int64)
    ts = t0 + rng.integers(0, 365 * 24 * 3600, n)
    frame = GeoFrame(
        key=key,
        filename=_filenames(dataset, year, n),
        lon=lon, lat=lat, timestamp=ts,
        class_id=rng.integers(0, len(CLASSES), n).astype(np.int8),
        det_count=rng.integers(0, 40, n).astype(np.int16),
        land_cover=rng.integers(0, len(LAND_COVERS), n).astype(np.int8),
        cloud_pct=rng.uniform(0, 100, n).astype(np.float32),
    )
    _FRAME_MEMO[memo_key] = frame
    return frame


class GeoDataStore:
    """Main memory. ``load`` charges DB latency; frames are memoised host-side
    (the memo is the *data platform's* store, not the LLM-visible cache).

    ``rows_range`` widens (or narrows) the per-frame row-count band — the
    cost-aware admission ablation uses a wide band so frame sizes diverge
    enough for size-weighted decisions to have signal. ``None`` keeps the
    default 12-18k band (62-94 MB), bit-identical to the original store.
    """

    def __init__(self, clock, rows_range: Optional[tuple] = None):
        self.clock = clock
        self.loads = 0
        self.rows_range = rows_range

    def _frame(self, key: str) -> GeoFrame:
        if key not in _ALL_KEYS:
            raise KeyError(f"unknown dataset-year {key!r}")
        return synth_frame(key, self.rows_range)

    def load(self, key: str) -> GeoFrame:
        f = self._frame(key)
        self.loads += 1
        self.clock.advance(self.clock.latency.db_load(f.size_mb))
        return f

    def peek(self, key: str) -> GeoFrame:
        """Latency-free access for gold-answer computation only."""
        return self._frame(key)

    def cache_read_latency(self, key: str) -> float:
        return self.clock.latency.cache_read(self._frame(key).size_mb)
