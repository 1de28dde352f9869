"""ctypes binding to the native example builder, `native/fastprep.cpp`
(the counterpart of mtamrecommender_tpu/data/fastprep.py).

The Python builder (`data/prepare.py`) walks per-example Python lists;
the native one does the same walk over flat int64 arrays and writes the
packed struct-of-arrays layout (`data/pipeline.PackedDataset`) directly.
Its C ABI is the JAX package's: ``fastprep_count(user_offsets, n_users)``
and ``fastprep_build(...)`` (`native/fastprep.cpp`).

The library is built at first use with

    g++ -O3 -std=c++17 -fPIC -shared -o <build>/libfastprep-<hash>.so fastprep.cpp

into ``build/torch_native/`` at the repository root (listed in
.gitignore), named by a hash of the source and the flags, so an edited
source rebuilds.  ``native/build/`` is the JAX package's and is left
alone.

Parity (tests/test_torch_data.py): the arrays equal the JAX package's
native builder's, and the rows equal the Python builder's as a multiset,
for the `unidirection`, `time_window` and `random` causality modes.  As
in the JAX package, the shuffle is a ``np.random.RandomState(seed)``
permutation, not the Python builder's ``random.Random`` stream, and a
test set over ``test_cap`` keeps the first ``test_cap`` rows of its
permutation.  `build_packed` raises RuntimeError where the JAX
package's does (an unknown causality, no toolchain), so callers fall
back to the Python builder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from mtamrecommender_tpu_torch.config import DataConfig
from mtamrecommender_tpu_torch.data.ingest import EventLog
from mtamrecommender_tpu_torch.data.pipeline import PackedDataset
from mtamrecommender_tpu_torch.data.prepare import (keep_last_duplicates,
                                                    map_process)
from mtamrecommender_tpu_torch.types import DatasetMeta

REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "native" / "fastprep.cpp"
BUILD_DIR = REPO_DIR / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

# 'random' maps to the unidirection window: for the dense behavior mask
# list the reference's random cut is randint(index, index) == index
# (mask_data_process.py:161-169), as the JAX package's builder notes.
_CAUSALITY_CODES = {"unidirection": 0, "time_window": 1, "random": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfastprep-{digest.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Compile into a temporary name, then rename into place, so a
    concurrent loader never sees half a library."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(tmp, path)
    except subprocess.CalledProcessError as exc:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{exc.stderr}") from exc
    finally:
        if tmp.exists():
            tmp.unlink()


def _load() -> ctypes.CDLL:
    """Load (building if needed) the shared library; RuntimeError where
    it cannot be built or loaded (the error is kept and raised again)."""
    global _lib, _load_error
    with _lock:
        if _lib is not None:
            return _lib
        if _load_error is not None:
            raise RuntimeError(_load_error)
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            _load_error = f"native toolchain unavailable: {exc}"
            raise RuntimeError(_load_error) from exc

        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.fastprep_count.restype = ctypes.c_int64
        lib.fastprep_count.argtypes = [i64p, ctypes.c_int64]
        lib.fastprep_build.restype = ctypes.c_int64
        lib.fastprep_build.argtypes = (
            [i64p, i64p, ctypes.c_int64]          # user ids/offsets
            + [i64p] * 4                          # items/cats/stamps/cat_of_item
            + [ctypes.c_int64] * 5                # max_len/causality/window/counts
            + [i32p, i32p, i32p, f32p, f32p, f32p, i32p,
               i32p, i32p, f32p, i32p, u8p])
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native builder can be loaded (toolchain present)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _as_i64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_packed(origin_data: EventLog, cfg: DataConfig
                 ) -> Tuple[PackedDataset, PackedDataset, DatasetMeta]:
    """Native counterpart of ``prepare_examples`` + ``pack_examples``.

    Returns ``(train, test, meta)``.  Raises RuntimeError when the native
    path cannot serve this config (no toolchain, an unknown causality
    mode) so callers fall back to the Python builder."""
    if cfg.causality not in _CAUSALITY_CODES:
        raise RuntimeError(
            f"fastprep does not support causality={cfg.causality!r}; "
            "use the Python builder")
    lib = _load()

    log, meta, item_category = map_process(origin_data)
    meta = meta._replace(max_seq_len=cfg.max_seq_len)

    # user_count_limit: the reference checks `now_count > limit` BEFORE
    # incrementing (prepare_data_base.py:243-246), so the first limit+1
    # users (ascending encoded id) are processed.
    users = np.unique(log.user_id)
    if len(users) > cfg.user_count_limit + 1:
        log = log.select(log.user_id <= users[cfg.user_count_limit])

    # per-user full-row dedup keep=last + time sort, done globally and
    # stably, as the JAX package's builder does
    if cfg.remove_duplicate:
        log = log.select(keep_last_duplicates(log))
    log = log.select(np.lexsort((log.time_stamp, log.user_id)))

    user_col = log.user_id
    boundaries = np.flatnonzero(np.diff(user_col)) + 1
    offsets = _as_i64(np.concatenate(([0], boundaries, [len(user_col)])))
    user_ids = _as_i64(user_col[offsets[:-1].astype(np.int64)])
    n_users = len(user_ids)

    items = _as_i64(log.item_id)
    cats = _as_i64(log.cat_id)
    stamps = _as_i64(log.time_stamp)
    cat_of_item = np.zeros((meta.item_count,), np.int64)
    for it, c in item_category.items():
        cat_of_item[it] = c

    n = int(lib.fastprep_count(_ptr(offsets, ctypes.c_int64),
                               ctypes.c_int64(n_users)))
    L = cfg.max_seq_len
    out = {
        "user_id": np.empty((n,), np.int32),
        "items": np.empty((n, L), np.int32),
        "cats": np.empty((n, L), np.int32),
        "times": np.empty((n, L), np.float32),
        "time_last": np.empty((n, L), np.float32),
        "time_now": np.empty((n, L), np.float32),
        "positions": np.empty((n, L), np.int32),
        "target_id": np.empty((n,), np.int32),
        "target_cat": np.empty((n,), np.int32),
        "target_time": np.empty((n,), np.float32),
        "seq_len": np.empty((n,), np.int32),
    }
    is_test = np.empty((n,), np.uint8)

    rows = int(lib.fastprep_build(
        _ptr(user_ids, ctypes.c_int64), _ptr(offsets, ctypes.c_int64),
        ctypes.c_int64(n_users),
        _ptr(items, ctypes.c_int64), _ptr(cats, ctypes.c_int64),
        _ptr(stamps, ctypes.c_int64), _ptr(cat_of_item, ctypes.c_int64),
        ctypes.c_int64(L), ctypes.c_int64(_CAUSALITY_CODES[cfg.causality]),
        ctypes.c_int64(24 * 3600 * cfg.time_window_days),
        ctypes.c_int64(meta.item_count), ctypes.c_int64(meta.category_count),
        _ptr(out["user_id"], ctypes.c_int32), _ptr(out["items"], ctypes.c_int32),
        _ptr(out["cats"], ctypes.c_int32), _ptr(out["times"], ctypes.c_float),
        _ptr(out["time_last"], ctypes.c_float),
        _ptr(out["time_now"], ctypes.c_float),
        _ptr(out["positions"], ctypes.c_int32),
        _ptr(out["target_id"], ctypes.c_int32),
        _ptr(out["target_cat"], ctypes.c_int32),
        _ptr(out["target_time"], ctypes.c_float),
        _ptr(out["seq_len"], ctypes.c_int32), _ptr(is_test, ctypes.c_uint8)))
    if rows != n:
        raise RuntimeError(f"fastprep_build wrote {rows} rows, expected {n}")

    def _dataset(mask: np.ndarray) -> PackedDataset:
        idx = np.flatnonzero(mask)
        return PackedDataset(meta=meta, **{k: v[idx] for k, v in out.items()})

    train = _dataset(is_test == 0)
    test = _dataset(is_test == 1)

    # seeded shuffle + test cap (prepare_data_base.py:189-196; the JAX
    # package's native stream, see the module docstring)
    rng = np.random.RandomState(cfg.seed)
    train = train.select(rng.permutation(len(train)))
    test = test.select(rng.permutation(len(test)))
    if len(test) > cfg.test_cap:
        test = test.select(np.arange(cfg.test_cap))
    return train, test, meta
