"""Clinical-accuracy evaluation of generated reports (a copy of
medvill_tpu/eval/chexpert.py).

Compares CheXpert-labeler CSV outputs for generated vs ground-truth reports
(reference: sc/report_label_eval.py; duplicated in sc/bleu.py:68-213).
The labeler emits one row per report with 14 observation columns valued in
{1.0 (positive), 0.0 (negative), -1.0 (uncertain), blank (unmentioned)}.

Implemented natively on the csv module + numpy (no pandas/sklearn dependency
needed at runtime; pandas is used only if available for convenience).

- `label_accuracy_v2`: per-row fraction of columns agreeing with the
  reference, ignoring rows with all-14 blanks, denominated by the number of
  non-blank reference columns (report_label_eval.py:61-73).
- `label_accuracy_v3`: per-row binary precision/recall for the positive /
  negative / uncertain classes plus per-row accuracy and macro P/R with
  blanks filled as 4 (report_label_eval.py:75-131).
- `label_accuracy_v4`: micro accuracy/precision/recall/F1 for the
  positive / negative / uncertain indicator matrices and their union
  (report_label_eval.py:133-183).
"""
from __future__ import annotations

import csv
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CHEXPERT_COLUMNS = [
    "No Finding", "Enlarged Cardiomediastinum", "Cardiomegaly",
    "Lung Lesion", "Lung Opacity", "Edema", "Consolidation", "Pneumonia",
    "Atelectasis", "Pneumothorax", "Pleural Effusion", "Pleural Other",
    "Fracture", "Support Devices",
]


def read_labeler_csv(path: str) -> np.ndarray:
    """CheXpert-labeler CSV -> [N, 14] float array with NaN for blanks.
    First column is the report text ('Reports'); the rest are observations."""
    rows: List[List[float]] = []
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        n_cols = len(header) - 1
        for row in reader:
            vals = []
            for cell in row[1:1 + n_cols]:
                cell = cell.strip()
                vals.append(float(cell) if cell else np.nan)
            rows.append(vals)
    return np.asarray(rows, dtype=np.float64)


def _micro_prf(ref: np.ndarray, hyp: np.ndarray) -> Tuple[float, float, float]:
    tp = float((ref.astype(bool) & hyp.astype(bool)).sum())
    fp = float((~ref.astype(bool) & hyp.astype(bool)).sum())
    fn = float((ref.astype(bool) & ~hyp.astype(bool)).sum())
    precision = tp / (tp + fp) if (tp + fp) else 0.0
    recall = tp / (tp + fn) if (tp + fn) else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) else 0.0)
    return precision, recall, f1


def label_accuracy_v2(hyp: np.ndarray, ref: np.ndarray
                      ) -> Tuple[float, np.ndarray]:
    """(reference: report_label_eval.py:61-73).  NaN == NaN counts as a
    match, like pandas (df_hyp == df_ref) treats equal-position NaNs as
    False... note: pandas `==` yields False for NaN pairs, so a blank in
    both columns does NOT count as agreement — we reproduce that."""
    agree = (hyp == ref)  # NaN == NaN -> False, matching pandas
    n_cols = ref.shape[1]
    accs = []
    for i in range(ref.shape[0]):
        n_nan = int(np.isnan(ref[i]).sum())
        if n_nan == n_cols:
            continue
        accs.append(agree[i].sum() / (n_cols - n_nan))
    acc_array = np.asarray(accs)
    return float(acc_array.mean()) if len(acc_array) else 0.0, acc_array


def _binary_pr(ref_row: np.ndarray, hyp_row: np.ndarray
               ) -> Tuple[float, float]:
    """sklearn binary precision/recall with pos_label=True, zero -> 0."""
    tp = float((ref_row & hyp_row).sum())
    fp = float((~ref_row & hyp_row).sum())
    fn = float((ref_row & ~hyp_row).sum())
    p = tp / (tp + fp) if (tp + fp) else 0.0
    r = tp / (tp + fn) if (tp + fn) else 0.0
    return p, r


def _macro_pr(ref_row: np.ndarray, hyp_row: np.ndarray
              ) -> Tuple[float, float]:
    """sklearn macro precision/recall with labels = sorted union of the
    values present in either row (sklearn's default when labels=None)."""
    labels = np.union1d(np.unique(ref_row), np.unique(hyp_row))
    ps, rs = [], []
    for c in labels:
        tp = float(((ref_row == c) & (hyp_row == c)).sum())
        fp = float(((ref_row != c) & (hyp_row == c)).sum())
        fn = float(((ref_row == c) & (hyp_row != c)).sum())
        ps.append(tp / (tp + fp) if (tp + fp) else 0.0)
        rs.append(tp / (tp + fn) if (tp + fn) else 0.0)
    return float(np.mean(ps)), float(np.mean(rs))


def label_accuracy_v3(hyp: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """Per-row class-conditioned precision/recall
    (reference: report_label_eval.py:75-131).

    For each row, binary precision/recall of the positive (==1.0),
    negative (==0.0), and uncertain (==-1.0) indicator vectors — a row
    enters a class's average only when the reference row actually contains
    that class (the reference's ``unique() != 1`` check; its indicator
    frames include the always-False 'Reports' column, so the check reduces
    to "any True present", and the extra False entry never affects P/R).
    Plus per-row accuracy and macro precision/recall over the raw values
    with blanks filled as 4 (``fillna(4)``)."""
    hyp = np.asarray(hyp, np.float64)
    ref = np.asarray(ref, np.float64)
    pos_p, pos_r, neg_p, neg_r, amb_p, amb_r = [], [], [], [], [], []
    accs, all_p, all_r = [], [], []
    for i in range(ref.shape[0]):
        for val, plist, rlist in ((1.0, pos_p, pos_r), (0.0, neg_p, neg_r),
                                  (-1.0, amb_p, amb_r)):
            r_ind = ref[i] == val
            h_ind = hyp[i] == val
            if r_ind.any():
                p, r = _binary_pr(r_ind, h_ind)
                plist.append(p)
                rlist.append(r)
        r_filled = np.where(np.isnan(ref[i]), 4.0, ref[i])
        h_filled = np.where(np.isnan(hyp[i]), 4.0, hyp[i])
        accs.append(float((r_filled == h_filled).mean()))
        p, r = _macro_pr(r_filled, h_filled)
        all_p.append(p)
        all_r.append(r)

    def m(x):
        return float(np.mean(x)) if x else float("nan")

    return {
        "acc": m(accs),
        "pos_precision": m(pos_p), "pos_recall": m(pos_r),
        "neg_precision": m(neg_p), "neg_recall": m(neg_r),
        "amb_precision": m(amb_p), "amb_recall": m(amb_r),
        "all_precision": m(all_p), "all_recall": m(all_r),
    }


def label_accuracy_v4(hyp: np.ndarray, ref: np.ndarray) -> Dict[str, tuple]:
    """(reference: report_label_eval.py:133-183).  Returns micro
    (accuracy, precision, recall, f1) for positive/negative/uncertain/all."""
    out = {}
    indicators = {
        "positive": 1.0, "negative": 0.0, "uncertain": -1.0,
    }
    mats = {}
    for name, val in indicators.items():
        h = (hyp == val).astype(int)
        r = (ref == val).astype(int)
        mats[name] = (r, h)
    mats["all"] = (sum(m[0] for m in mats.values()),
                   sum(m[1] for m in mats.values()))
    for name, (r, h) in mats.items():
        acc = float((r == h).sum()) / r.size
        p, rec, f1 = _micro_prf(r, h)
        out[name] = (acc, p, rec, f1)
    return out


def evaluate_reports(hypothesis_csv: str, reference_csv: str) -> dict:
    hyp = read_labeler_csv(hypothesis_csv)
    ref = read_labeler_csv(reference_csv)
    acc_v2, _ = label_accuracy_v2(hyp, ref)
    v3 = label_accuracy_v3(hyp, ref)
    v4 = label_accuracy_v4(hyp, ref)
    return {"acc_v2": acc_v2, "v3": v3, "v4": v4}
