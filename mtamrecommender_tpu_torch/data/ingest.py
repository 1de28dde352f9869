"""Raw-dataset ingestion to the canonical event log (the counterpart of
mtamrecommender_tpu/data/ingest.py, without pandas).

Canonical schema: ``user_id, item_id, time_stamp, cat_id``, the contract
of every loader in the reference's ``DataHandle/``
(`DataHandle/get_origin_data_ml.py:33-39`).  The JAX package keeps the
log in a pandas DataFrame; the port keeps it in an `EventLog`, four
numpy columns of one length.  Each pandas step of the JAX loaders is
numpy code here that yields the same rows in the same order:

  * ``groupby(...).transform("size")`` -> ``np.unique(return_inverse,
    return_counts)``;
  * ``DataFrame.sample(frac, random_state=rng)`` -> ``rng.choice(n,
    round(frac * n), replace=False)`` over the sorted unique ids, which
    is what pandas calls;
  * ``pd.merge(ratings, movies, on="movieId")`` -> each rating, in the
    ratings' order, joined with its movie rows;
  * ``pd.read_csv`` / ``to_csv`` -> `read_csv` / `write_csv`, which infer
    int64, then float64, then string columns as pandas does and write
    pandas' CSV layout, so a cache written by either package loads in
    the other.

The synthetic generators are the JAX package's loops verbatim: they draw
from ``np.random.RandomState(cfg.seed)`` in the same order.
"""

from __future__ import annotations

import csv
import logging
import math
import os
import re
from dataclasses import dataclass, fields
from typing import Callable, Dict, List, Sequence

import numpy as np

from mtamrecommender_tpu_torch.config import DataConfig

logger = logging.getLogger("mtamrec_torch.data")

COLUMNS = ("user_id", "item_id", "time_stamp", "cat_id")


@dataclass
class EventLog:
    """A behavior log as four numpy columns of one length, in row order.
    ``log["item_id"]`` reads a column, as a DataFrame's does."""

    user_id: np.ndarray
    item_id: np.ndarray
    time_stamp: np.ndarray
    cat_id: np.ndarray

    def __len__(self) -> int:
        return int(self.user_id.shape[0])

    def __getitem__(self, name: str) -> np.ndarray:
        if name not in COLUMNS:
            raise KeyError(name)
        return getattr(self, name)

    def select(self, idx: np.ndarray) -> "EventLog":
        """The rows ``idx`` (indices or a boolean mask), in that order."""
        return EventLog(**{f.name: getattr(self, f.name)[idx]
                           for f in fields(self)})

    @classmethod
    def from_rows(cls, rows: Sequence[tuple]) -> "EventLog":
        """(user, item, time, category) tuples of ints -> int64 columns,
        the dtype a DataFrame built from Python ints gets."""
        arr = np.asarray(rows, dtype=np.int64).reshape(-1, 4)
        return cls(*(np.ascontiguousarray(arr[:, i]) for i in range(4)))


# ------------------------------------------------------------ CSV

_INT = re.compile(r"^\s*[+-]?\d+\s*$")
# the strings pandas' read_csv reads as NaN by default
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None",
       "n/a", "nan", "null"}


def _column(values: List[str]) -> np.ndarray:
    """One CSV column with read_csv's inference: int64 where every cell
    is an integer, float64 where every cell is a number or NaN, else
    strings (NaN where a cell is empty or NA)."""
    if values and all(_INT.match(v) for v in values):
        return np.array([int(v) for v in values], dtype=np.int64)
    try:
        return np.array([math.nan if v in _NA else float(v)
                         for v in values], dtype=np.float64)
    except ValueError:
        return np.array([math.nan if v in _NA else v for v in values],
                        dtype=object)


def read_csv(path: str, encoding: str = "utf-8") -> Dict[str, np.ndarray]:
    """A CSV file with a header line -> {column name: numpy column}."""
    with open(path, newline="", encoding=encoding) as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r for r in reader if r]
    for i, r in enumerate(rows):
        if len(r) != len(header):
            raise ValueError(f"{path}: line {i + 2} has {len(r)} fields, "
                             f"the header {len(header)}")
    return {name: _column([r[j] for r in rows])
            for j, name in enumerate(header)}


def _cell(v) -> str:
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else repr(float(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return str(v)


def write_csv(path: str, log: EventLog) -> None:
    """``log`` as pandas' ``to_csv(index=False)`` writes it: the header,
    then one line a row, fields quoted only where they must be."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(COLUMNS)
        cols = [log[c].tolist() for c in COLUMNS]
        for row in zip(*cols):
            writer.writerow([_cell(v) for v in row])


def _from_csv(path: str) -> EventLog:
    cols = read_csv(path)
    missing = [c for c in COLUMNS if c not in cols]
    if missing:
        raise ValueError(f"{path}: missing canonical columns {missing}")
    return EventLog(**{c: cols[c] for c in COLUMNS})


# ------------------------------------------------------------ filters

def _counts_per_row(col: np.ndarray) -> np.ndarray:
    """Each row's group size by ``col`` (groupby().transform("size")); a
    row whose key is NaN belongs to no group, as pandas drops NaN keys."""
    _, inverse, counts = np.unique(col, return_inverse=True,
                                   return_counts=True)
    per_row = counts[inverse.reshape(-1)]
    if col.dtype.kind == "f":
        per_row = np.where(np.isnan(col), 0, per_row)
    return per_row


def min_activity_filter(log: EventLog, min_user: int = 5,
                        min_item: int = 5) -> EventLog:
    """Drop the events of items below ``min_item`` events, then of users
    below ``min_user``, once each (JAX `min_activity_filter`)."""
    log = log.select(_counts_per_row(log.item_id) >= min_item)
    return log.select(_counts_per_row(log.user_id) >= min_user)


def _nunique(col: np.ndarray) -> int:
    if col.dtype.kind == "f":
        col = col[~np.isnan(col)]
    return int(len(np.unique(col)))


def data_statistics(log: EventLog) -> Dict[str, float]:
    """getDataStatistics equivalent: corpus-level counts."""
    users = _nunique(log.user_id)
    stats = {
        "events": int(len(log)),
        "users": users,
        "items": _nunique(log.item_id),
        "categories": _nunique(log.cat_id),
        "events_per_user": float(len(log) / max(users, 1)),
    }
    logger.info("data statistics: %s", stats)
    return stats


# ------------------------------------------------------------ ml-1m

def _read_dat(path: str, n_fields: int, encoding: str = "utf-8"
              ) -> List[List[str]]:
    """A '::'-separated file without a header; blank lines skipped."""
    with open(path, encoding=encoding) as f:
        rows = [line.split("::") for line in f.read().splitlines() if line]
    for i, r in enumerate(rows):
        if len(r) != n_fields:
            raise ValueError(f"{path}: line {i + 1} has {len(r)} fields, "
                             f"expected {n_fields}")
    return rows


def load_ml_1m(cfg: DataConfig) -> EventLog:
    """MovieLens-1M loader (get_origin_data_ml.py:9-54).

    Reads `movies.dat` + `ratings.dat` ('::'-separated), samples
    ``user_sample_frac`` of users (``RandomState(cfg.seed)``), joins the
    genres string as cat_id, renames to the canonical schema, filters,
    caches a CSV under ``orgin_data/movielens.csv``."""
    cache = os.path.join(cfg.data_root, "orgin_data", "movielens.csv")
    if os.path.exists(cache):
        return _from_csv(cache)
    raw = os.path.join(cfg.data_root, "raw_data", "ml-1m")
    movies = _read_dat(os.path.join(raw, "movies.dat"), 3, "latin-1")
    movie_id = _column([r[0] for r in movies])
    genres = np.array([r[2] for r in movies], dtype=object)
    ratings = _read_dat(os.path.join(raw, "ratings.dat"), 4)
    user, movie, _, stamp = (_column([r[j] for r in ratings])
                             for j in range(4))

    # user_counts.sample(frac, random_state=rng): pandas draws
    # rng.choice(n, round(frac * n), replace=False) over the groupby's
    # sorted index, then isin() keeps the ratings' order
    rng = np.random.RandomState(cfg.seed)
    users = np.unique(user)
    size = round(cfg.user_sample_frac * len(users))
    sampled = users[rng.choice(len(users), size=size, replace=False)]
    keep = np.isin(user, sampled)
    user, movie, stamp = user[keep], movie[keep], stamp[keep]

    # pd.merge(ratings, movies, on="movieId"): each rating in order, with
    # each of its movie's rows in the movies file's order
    by_id = np.argsort(movie_id, kind="stable")
    lo = np.searchsorted(movie_id[by_id], movie, side="left")
    hi = np.searchsorted(movie_id[by_id], movie, side="right")
    reps = hi - lo
    rows = np.repeat(np.arange(len(movie)), reps)
    first = np.repeat(lo - np.cumsum(reps) + reps, reps)
    match = by_id[first + np.arange(len(rows))]
    merged = EventLog(user_id=user[rows], item_id=movie[rows],
                      time_stamp=stamp[rows], cat_id=genres[match])
    filtered = min_activity_filter(merged, cfg.min_user_actions,
                                   cfg.min_item_actions)
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    write_csv(cache, filtered)
    return filtered


def _csv_loader(filename: str, colmap: Dict[str, str]
                ) -> Callable[[DataConfig], EventLog]:
    """Loader family for the canonicalized-CSV datasets
    (yoochoose/tmall/taobao/amazon-*) under ``orgin_data/<name>.csv``."""

    def load(cfg: DataConfig) -> EventLog:
        path = os.path.join(cfg.data_root, "orgin_data", filename)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found: place the canonicalized CSV there "
                f"(columns {sorted(colmap)} -> canonical schema)")
        cols = read_csv(path)
        if colmap:
            cols = {colmap.get(k, k): v for k, v in cols.items()}
        missing = [c for c in COLUMNS if c not in cols]
        if missing:
            raise ValueError(f"{path}: missing canonical columns {missing}")
        return min_activity_filter(EventLog(**{c: cols[c] for c in COLUMNS}),
                                   cfg.min_user_actions, cfg.min_item_actions)

    return load


# ------------------------------------------------------------ synthetic

def load_synthetic(cfg: DataConfig) -> EventLog:
    """Seeded synthetic behavior log with realistic temporal structure
    (JAX `load_synthetic`): users draw items from a user-specific
    Zipf-tilted catalog slice; gaps mix minutes, hours and days."""
    rng = np.random.RandomState(cfg.seed)
    users, items = cfg.synth_users, cfg.synth_items
    cats = cfg.synth_categories
    item_cat = rng.randint(0, cats, size=items)
    # Zipf-ish global popularity
    pop = 1.0 / (np.arange(1, items + 1) ** 0.8)
    rows = []
    base_time = 1_000_000_000
    for u in range(users):
        n = max(3, int(rng.poisson(cfg.synth_events_per_user)))
        # user taste: re-weight a random slice of the catalog
        taste = pop.copy()
        fav = rng.randint(0, items, size=max(4, items // 50))
        taste[fav] *= 20.0
        taste /= taste.sum()
        chosen = rng.choice(items, size=n, p=taste)
        gaps = rng.choice([60, 600, 3600, 6 * 3600, 86400, 3 * 86400],
                          size=n, p=[.15, .2, .25, .2, .15, .05])
        t = base_time + rng.randint(0, 86400) + np.cumsum(gaps)
        for i in range(n):
            rows.append((u, int(chosen[i]), int(t[i]), int(item_cat[chosen[i]])))
    return EventLog.from_rows(rows)


def load_synthetic_sessions(cfg: DataConfig) -> EventLog:
    """Synthetic log with time-dependent dynamics (JAX
    `load_synthetic_sessions`): sessions locked onto one category with
    minute-scale gaps inside and day-scale gaps between, and decaying
    re-consumption of recent items."""
    rng = np.random.RandomState(cfg.seed)
    users, items = cfg.synth_users, cfg.synth_items
    cats = cfg.synth_categories
    item_cat = rng.randint(0, cats, size=items)
    items_by_cat = [np.nonzero(item_cat == c)[0] for c in range(cats)]
    # zipf weights within each category
    weights_by_cat = []
    for c in range(cats):
        n = len(items_by_cat[c])
        w = 1.0 / (np.arange(1, n + 1) ** 0.9) if n else np.zeros(0)
        weights_by_cat.append(w / w.sum() if n else w)
    rows = []
    base_time = 1_000_000_000
    for u in range(users):
        taste = rng.dirichlet(np.ones(cats) * 0.3)
        n_events = max(4, int(rng.poisson(cfg.synth_events_per_user)))
        t = base_time + int(rng.randint(0, 86400))
        cat = int(rng.choice(cats, p=taste))
        recent: list = []
        emitted = 0
        while emitted < n_events:
            # one session in category `cat`
            session_len = min(1 + rng.poisson(3), n_events - emitted)
            for _ in range(session_len):
                if recent and rng.rand() < 0.25:
                    item = recent[-1 - rng.randint(0, min(len(recent), 5))]
                else:
                    pool = items_by_cat[cat]
                    if len(pool) == 0:
                        item = int(rng.randint(0, items))
                    else:
                        item = int(rng.choice(pool, p=weights_by_cat[cat]))
                rows.append((u, item, t, int(item_cat[item])))
                recent.append(item)
                emitted += 1
                t += int(rng.choice([30, 60, 180, 600],
                                    p=[.3, .35, .25, .1]))
            # between sessions: long gap + possible interest drift
            t += int(rng.choice([4 * 3600, 86400, 3 * 86400, 7 * 86400],
                                p=[.3, .4, .2, .1]))
            if rng.rand() < 0.6:
                cat = int(rng.choice(cats, p=taste))
    return EventLog.from_rows(rows)


def load_synthetic_timed(cfg: DataConfig) -> EventLog:
    """Gap-decisive synthetic log (JAX `load_synthetic_timed`): the next
    event's distribution depends on the gap before it.  A short gap
    (30 s - 10 min, p=.5) continues the session's category, with p=.3 a
    repeat of one of the last 3 items; a medium gap (1-6 h, p=.3) hops
    the category through a global derangement; a long gap (1-7 d, p=.2)
    returns to the user's anchor item with p=.8, else hops through a
    second derangement."""
    rng = np.random.RandomState(cfg.seed)
    users, items = cfg.synth_users, cfg.synth_items
    cats = cfg.synth_categories
    item_cat = rng.randint(0, cats, size=items)
    items_by_cat = [np.nonzero(item_cat == c)[0] for c in range(cats)]
    weights_by_cat = []
    for c in range(cats):
        n = len(items_by_cat[c])
        w = 1.0 / (np.arange(1, n + 1) ** 1.2) if n else np.zeros(0)
        weights_by_cat.append(w / w.sum() if n else w)

    def derangement() -> np.ndarray:
        if cats < 2:
            # no derangement exists: the category hop is the identity
            return np.arange(cats)
        while True:
            p = rng.permutation(cats)
            if not np.any(p == np.arange(cats)):
                return p

    t_med, t_long = derangement(), derangement()

    def zipf_item(c: int) -> int:
        pool = items_by_cat[c]
        if len(pool) == 0:
            return int(rng.randint(0, items))
        return int(rng.choice(pool, p=weights_by_cat[c]))

    rows = []
    base_time = 1_000_000_000
    for u in range(users):
        anchor = int(rng.randint(0, items))
        n_events = max(6, int(rng.poisson(cfg.synth_events_per_user)))
        t = base_time + int(rng.randint(0, 86400))
        cat = int(rng.randint(0, cats))
        item = zipf_item(cat)
        recent = [item]
        rows.append((u, item, t, int(item_cat[item])))
        for _ in range(n_events - 1):
            bucket = rng.choice(3, p=[.5, .3, .2])
            if bucket == 0:            # short: session continues
                t += int(rng.randint(30, 600))
                if rng.rand() < 0.3:
                    item = recent[-1 - rng.randint(0, min(len(recent), 3))]
                else:
                    item = zipf_item(cat)
            elif bucket == 1:          # medium: global category hop
                t += int(rng.randint(1, 7)) * 3600
                cat = int(t_med[cat])
                item = zipf_item(cat)
            else:                      # long: anchored return
                t += int(rng.randint(24, 169)) * 3600
                if rng.rand() < 0.8:
                    item = anchor
                    cat = int(item_cat[anchor])
                else:
                    cat = int(t_long[cat])
                    item = zipf_item(cat)
            rows.append((u, item, t, int(item_cat[item])))
            recent.append(item)
    return EventLog.from_rows(rows)


_LOADERS: Dict[str, Callable[[DataConfig], EventLog]] = {
    "synthetic_sessions": load_synthetic_sessions,
    "synthetic_timed": load_synthetic_timed,
    "ml_1m": load_ml_1m,
    "movielen": load_ml_1m,
    "synthetic": load_synthetic,
    "yoochoose": _csv_loader("yoochoose.csv", {}),
    "tmall": _csv_loader("tmall.csv", {}),
    "taobaoapp": _csv_loader("taobaoapp.csv", {}),
    "music": _csv_loader("amazon_music.csv", {}),
    "beauty": _csv_loader("amazon_beauty.csv", {}),
    "elec": _csv_loader("amazon_elec.csv", {}),
}


def load_origin_data(cfg: DataConfig) -> EventLog:
    try:
        loader = _LOADERS[cfg.dataset]
    except KeyError:
        raise KeyError(f"unknown dataset {cfg.dataset!r}; known: {sorted(_LOADERS)}")
    return loader(cfg)
