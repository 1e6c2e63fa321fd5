"""Sharded, atomic, async checkpoints in the reference's on-disk format
(``repro.distributed.checkpoint``).

Layout:  <dir>/step_<n>/shard_<r>.ckpt + MANIFEST.json, committed by an
atomic rename of a temporary directory. A shard is the msgpack array of one
record per leaf, ``{"path", "dtype", "shape", "data"}``, compressed with
zstd (level 3) where the ``zstandard`` module is present and with zlib
(level 6) otherwise; restore sniffs the codec. The manifest holds a
blake2b-16 digest of each compressed shard, so a partial or corrupt step
is skipped at restore.

The files are the reference's, byte for byte in the msgpack layer: leaves
are visited with dict keys sorted and paths spelt as
``jax.tree_util.keystr`` spells them (``['params']['dec']['attn']['wq']``,
``[0]`` for a list index); a bf16 leaf is stored as its 16-bit pattern
with the tag ``"bfloat16"``, any other leaf with numpy's dtype string
(``'<f4'``, ``'<i4'``; a Python int is ``'<i8'``, as ``np.asarray`` makes
it). The msgpack codec is the port's own (``_msgpack``), and bf16 needs no
``ml_dtypes``. ``restore`` returns CPU tensors; the caller moves them.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import _msgpack

try:                                   # zstd is optional; zlib ships with
    import zstandard                   # CPython and keeps checkpoints
except ImportError:                    # readable on minimal images
    zstandard = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


class _ZlibCompressor:
    def __init__(self, level: int = 6):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)


def _decompress(blob: bytes) -> bytes:
    """Codec-sniffing decompress so repos written with either codec restore."""
    if blob[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise RuntimeError("checkpoint is zstd-compressed but the "
                               "zstandard module is unavailable")
        return zstandard.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)


def flatten_with_path(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in ``jax.tree_util.tree_flatten_with_path``
    order: dict keys sorted, lists and tuples by index; None holds no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_with_path(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten_with_path(v, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def _map_with_path(fn, tree, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by fn(path, leaf)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return None if tree is None else fn(prefix, tree)


def _record(path: str, leaf) -> Dict[str, Any]:
    """One leaf as a record: a host copy of its bytes (the snapshot)."""
    bf16 = False
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        bf16 = t.dtype == torch.bfloat16
        arr = (t.view(torch.int16) if bf16 else t).numpy()
    else:
        arr = np.asarray(leaf)
    return {"path": path, "dtype": "bfloat16" if bf16 else arr.dtype.str,
            "shape": list(arr.shape), "data": arr.tobytes()}


def _tree_to_records(tree) -> List[Dict[str, Any]]:
    return [_record(p, leaf) for p, leaf in flatten_with_path(tree)]


def _records_to_leaves(recs: List[Dict[str, Any]]) -> Dict[str, torch.Tensor]:
    leaves = {}
    for r in recs:
        bf16 = r["dtype"] == "bfloat16"
        arr = np.frombuffer(r["data"], np.int16 if bf16 else np.dtype(r["dtype"]))
        t = torch.from_numpy(arr.reshape(r["shape"]).copy())
        leaves[r["path"]] = t.view(torch.bfloat16) if bf16 else t
    return leaves


class Checkpointer:
    """Writes and reads ``step_<n>`` directories under ``directory``,
    keeping the newest ``keep`` valid steps.

    ``last_save`` holds the newest write's sizes and times: ``snapshot_s``
    (the host copy, on the caller's thread), ``write_s`` (pack, compress,
    write, digest and rename, on the writer's thread for ``save_async``),
    ``raw_bytes`` (the msgpack bytes) and ``bytes`` (on disk).
    ``last_restore`` holds the newest restore's: ``seconds`` (all of it),
    ``valid_s`` (the digest pass), ``bytes`` and ``raw_bytes``."""

    def __init__(self, directory: str, keep: int = 3, shard_id: int = 0,
                 n_shards: int = 1):
        self.dir = directory
        self.keep = keep
        self.shard_id = shard_id
        self.n_shards = n_shards
        os.makedirs(directory, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None
        self.codec = "zstd" if zstandard is not None else "zlib"
        self._zc = (zstandard.ZstdCompressor(level=3)
                    if zstandard is not None else _ZlibCompressor(6))
        self.last_save: Dict[str, float] = {}
        self.last_restore: Dict[str, float] = {}

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def available_steps(self) -> List[int]:
        steps = []
        for name in sorted(os.listdir(self.dir)):
            if not name.startswith("step_"):
                continue
            d = os.path.join(self.dir, name)
            if self._valid(d):
                steps.append(int(name.split("_")[1]))
        return steps

    def _valid(self, d: str) -> bool:
        man = os.path.join(d, "MANIFEST.json")
        if not os.path.exists(man):
            return False
        try:
            with open(man) as f:
                manifest = json.load(f)
            for shard, digest in manifest["shards"].items():
                p = os.path.join(d, shard)
                if not os.path.exists(p):
                    return False
                with open(p, "rb") as f:
                    h = hashlib.blake2b(f.read(), digest_size=16).hexdigest()
                if h != digest:
                    return False
            return True
        except (json.JSONDecodeError, KeyError, OSError):
            return False

    # -- save ----------------------------------------------------------------
    @staticmethod
    def _snapshot(tree) -> Tuple[List[Dict[str, Any]], float]:
        t0 = time.perf_counter()
        recs = _tree_to_records(tree)
        return recs, time.perf_counter() - t0

    def save(self, step: int, tree) -> str:
        return self._write(step, *self._snapshot(tree))

    def save_async(self, step: int, tree) -> threading.Thread:
        recs, snap_s = self._snapshot(tree)  # synchronous host snapshot
        if self._async_thread is not None:
            self._async_thread.join()
        t = threading.Thread(target=self._write, args=(step, recs, snap_s),
                             daemon=True)
        t.start()
        self._async_thread = t
        return t

    def wait(self):
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _write(self, step: int, recs, snapshot_s: float = 0.0) -> str:
        t0 = time.perf_counter()
        final = self._step_dir(step)
        tmp = final + f".tmp{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        shard_name = f"shard_{self.shard_id:04d}.ckpt"
        raw = _msgpack.packb(recs)
        blob = self._zc.compress(raw)
        with open(os.path.join(tmp, shard_name), "wb") as f:
            f.write(blob)
        digest = hashlib.blake2b(blob, digest_size=16).hexdigest()
        manifest = {"step": step, "n_shards": self.n_shards,
                    "shards": {shard_name: digest}}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic commit
        self._gc()
        self.last_save = {"step": step, "snapshot_s": snapshot_s,
                          "write_s": time.perf_counter() - t0,
                          "raw_bytes": len(raw), "bytes": len(blob)}
        return final

    def _gc(self):
        steps = self.available_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def restore(self, step: int, like=None):
        """The leaves of ``step`` as CPU tensors: a {path: tensor} dict, or
        a tree of ``like``'s structure (KeyError if a leaf is missing)."""
        t0 = time.perf_counter()
        d = self._step_dir(step)
        if not self._valid(d):
            raise FileNotFoundError(f"no valid checkpoint at step {step}")
        valid_s = time.perf_counter() - t0
        leaves: Dict[str, torch.Tensor] = {}
        nbytes = raw_bytes = 0
        for name in sorted(os.listdir(d)):
            if not name.endswith(".ckpt"):
                continue
            with open(os.path.join(d, name), "rb") as f:
                blob = f.read()
            raw = _decompress(blob)
            leaves.update(_records_to_leaves(_msgpack.unpackb(raw)))
            nbytes, raw_bytes = nbytes + len(blob), raw_bytes + len(raw)
        self.last_restore = {"step": step, "valid_s": valid_s,
                             "seconds": time.perf_counter() - t0,
                             "bytes": nbytes, "raw_bytes": raw_bytes}
        if like is None:
            return leaves

        def take(key, _):
            if key not in leaves:
                raise KeyError(f"checkpoint missing leaf {key}")
            return leaves[key]

        return _map_with_path(take, like)

    def restore_latest(self, like=None):
        steps = self.available_steps()
        if not steps:
            return None
        # walk backwards past any corrupt tail
        for s in reversed(steps):
            try:
                return self.restore(s, like=like)
            except (FileNotFoundError, KeyError, ValueError):
                continue
        return None
