"""Legacy multi-table embedding-config CSV reader (twin of
mtamrecommender_tpu/utils/embedding_config.py, kept here so the port
imports nothing of the JAX package).

An ordered {column_name: (vocab_size, embedding_dim)} mapping from a csv
with rows ``name,vocab,dim`` (the reference's
util/read_embedding_dic.py:5-15); blank rows and rows starting with
``#`` are skipped.
"""

from __future__ import annotations

import csv
from collections import OrderedDict
from typing import Tuple


def read_embedding_config(path: str) -> "OrderedDict[str, Tuple[int, int]]":
    out: "OrderedDict[str, Tuple[int, int]]" = OrderedDict()
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            name, vocab, dim = row[0].strip(), int(row[1]), int(row[2])
            out[name] = (vocab, dim)
    return out
