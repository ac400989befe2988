"""What decides ``correct``, and ``recall_at_8``: the program's answers
against the plain reference, after the window.

A sample of the window's answers, drawn from the seed, is judged.  For each
answer the reference computes the partitioned Top-K of its query over the
collection as the configuration stores it (every value in the stated
format).  An answer's gap is the larger of

* the widest distance between the program's j-th score and the reference's
  j-th score (j < K), and
* the widest distance between a score the program returned and the
  reference's score of the row id it returned with it,

so a wrong id, a wrong score or a missed candidate all show, while two rows
whose scores tie may come in either order.  An id outside the collection or
a score that is not finite makes the gap infinite.  ``score_gap`` is the
widest gap of the sample; ``missing`` counts the answers that never came.
``recall_at_8`` is the mean share of each query's exact (f32, all rows) top
8 among the first 8 ids returned.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from perfbench import gen
from perfbench.reference import topk as topk_ref

SAMPLE = 2048
BLOCK = 64
RECALL_AT = 8


def sample(n_answers: int, size: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(gen.sub_seed(seed, "check"))
    return np.sort(rng.choice(n_answers, size=min(size, n_answers), replace=False))


def judge(config: dict, csr, pool: np.ndarray, out: Dict, seed: int, device) -> Dict:
    """{"score_gap", "missing", "recall_at_8", "judged"}."""
    device = torch.device(device)
    big_k = config["big_k"]
    pick = sample(len(out["qidx"]), SAMPLE, seed)
    qidx = out["qidx"][pick]
    prog_v = np.asarray(out["vals"])[pick] if len(pick) else np.zeros((0, big_k))
    prog_r = np.asarray(out["rows"])[pick] if len(pick) else np.zeros((0, big_k))
    bounds = topk_ref.partition_bounds(csr.n_rows, config["num_partitions"])
    coll = topk_ref.Collection(csr.indptr, csr.indices, csr.n_cols, device)
    values = torch.as_tensor(csr.data, device=device)
    stated = coll.matrix(topk_ref.decode(values, config["value_format"]))
    exact = coll.matrix(values)
    gaps = np.full(len(pick), np.inf)
    hits = np.zeros(len(pick))
    uniq, inv = np.unique(qidx, return_inverse=True)
    shape_ok = prog_v.shape[1:] == (big_k,) and prog_r.shape[1:] == (big_k,)
    for lo in range(0, len(uniq), BLOCK):
        xs = torch.as_tensor(pool[uniq[lo:lo + BLOCK]], device=device)
        scores = topk_ref.row_scores(stated, xs)
        ref_v, _ = topk_ref.partitioned_topk(scores, bounds, config["k"], big_k)
        top = topk_ref.exact_topk_rows(topk_ref.row_scores(exact, xs), RECALL_AT).cpu().numpy()
        for a in np.nonzero((inv >= lo) & (inv < lo + BLOCK))[0]:
            j = int(inv[a]) - lo
            if not shape_ok:
                continue
            v = torch.as_tensor(prog_v[a], device=device, dtype=torch.float32)
            r = torch.as_tensor(prog_r[a], device=device).to(torch.int64)
            valid = bool(((r >= 0) & (r < csr.n_rows)).all() and torch.isfinite(v).all())
            hits[a] = len(set(prog_r[a][:RECALL_AT].tolist()) & set(top[j].tolist()))
            if not valid:
                continue
            own = scores[r, j]
            gaps[a] = max(float((v - ref_v[j]).abs().max()), float((v - own).abs().max()))
        del scores
    return {"score_gap": float(gaps.max()) if len(gaps) else float("inf"),
            "missing": int(out["failed"]),
            "recall_at_8": float(hits.mean() / RECALL_AT) if len(hits) else 0.0,
            "judged": int(len(pick))}
