"""Shared inputs of the port's data-path tests (tests/test_torch_*.py)."""

import os

import numpy as np


def write_tie_fixture(path):
    """An ml-1m-format pair: 20 movies (latin-1 titles) and 6 users.  User
    1 rates 400 times within 60 distinct seconds, 40 of them repeats of
    earlier rows; the others rate 30-60 times, user 4 with same-second
    pairs; one rating names movie 999, which the movies file lacks."""
    rng = np.random.RandomState(11)
    os.makedirs(path)
    genres = ["Drama", "Comedy|Romance", "Action|Thriller", "Children's"]
    with open(os.path.join(path, "movies.dat"), "w", encoding="latin-1") as f:
        for m in range(1, 21):
            f.write(f"{m}::Fixture \xe9t\xe9 {m} (199{m % 10})::"
                    f"{genres[m % 4]}\n")
    rows = []
    base = 978300000
    seconds = np.sort(rng.randint(0, 60, 360))
    for s in seconds:
        rows.append((1, int(rng.randint(1, 21)), 3, base + int(s) * 7))
    rows += [rows[int(j)] for j in rng.randint(0, 360, 40)]
    for u, n in ((2, 30), (3, 45), (4, 60), (5, 35), (6, 50)):
        stamps = base + np.cumsum(rng.randint(0, 3, n)) * 3600
        for t in stamps:
            rows.append((u, int(rng.randint(1, 21)), 4, int(t)))
    rows.append((3, 999, 5, base))
    with open(os.path.join(path, "ratings.dat"), "w") as f:
        for r in rows:
            f.write("::".join(str(v) for v in r) + "\n")
