"""N-gram LM rescoring of CTC frame posteriors (counterpart of
dtlr_tpu/ngram/lm_decode.py, numpy and ``math`` only).

Covers reference ngram/ (clean_gen_ngram_preds.py, prediction_helpers.py):
- frame posteriors = the same x-sort + blank synthesis as the CTC loss,
  with a logits temperature ``multiply_pred_logits_by`` (reference
  prediction_helpers.py:5-45; IAM.yaml uses x2), made by the caller
  (ngram/rescore.py)
- per-word gating: words that are all-uppercase, contain digits or
  dashes keep the greedy prediction (reference :125-172)
- beam decode against a char-level n-gram LM

The reference uses kenlm + flashlight (host C++ libraries). This module
has:
  * ``CharNgramLM`` — a pure-python char n-gram with the same scoring
    contract (trainable from a text corpus; kenlm .arpa files load too)
  * ``ctc_beam_search`` — CTC prefix beam search with LM fusion
    (lm_weight, reference IAM.yaml:10-16)
  * ``LexiconTrie`` and ``rescore_line`` (per-word decode, gating, the
    lexicon arm with its out-of-vocabulary margin)
There is no kenlm branch. The arithmetic is the JAX package's, operation
for operation in float64 (the candidate order of ``np.argsort``, the
stable ``sorted`` of the beams, the first maximum of the pool), so both
packages return the same strings and scores.
"""

from __future__ import annotations

import math
import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class CharNgramLM:
    """Char-level n-gram LM scoring log10 P(c | context).

    ``smoothing="stupid"`` is stupid-backoff (alpha 0.4); ``"kn"`` is
    interpolated Kneser-Ney with one absolute discount per order
    (D_n = n1/(n1+2*n2)), the smoothing family kenlm's lmplz uses for
    the reference's LMs (reference ngram/train_n_gram.sh). Unlike
    stupid-backoff, KN conditionals are properly normalized
    (sum_c P(c|ctx) == 1). Can be built from a corpus or loaded from an
    ARPA file (the format kenlm emits; the reference builds a 6-gram)."""

    def __init__(self, order: int = 6, add_k: float = 0.01,
                 smoothing: str = "stupid"):
        if smoothing not in ("stupid", "kn"):
            raise ValueError(f"unknown smoothing {smoothing!r}")
        self.order = order
        self.add_k = add_k
        self.smoothing = smoothing
        self.counts: List[Dict[str, Dict[str, float]]] = [
            defaultdict(lambda: defaultdict(float)) for _ in range(order)
        ]
        self.vocab: set = set()
        self.arpa: Optional[Dict[int, Dict[str, Tuple[float, float]]]] = None
        self._totals: Optional[List[Dict[str, float]]] = None
        self._kn: Optional[tuple] = None

    # ---------------------------------------------------------- training
    def fit(self, lines: Sequence[str]):
        for line in lines:
            text = "^" * (self.order - 1) + line + "$"
            for i in range(self.order - 1, len(text)):
                c = text[i]
                self.vocab.add(c)
                for n in range(self.order):
                    ctx = text[i - n : i]
                    self.counts[n][ctx][c] += 1
        self._totals = None
        self._kn = None
        return self

    def logp(self, context: str, char: str) -> float:
        """log10 P(char | context) under the configured smoothing."""
        if self.arpa is not None:
            return self._arpa_logp(context, char)
        if self.smoothing == "kn":
            return self._kn_logp(context, char)
        context = ("^" * (self.order - 1) + context)[-(self.order - 1):]
        if self._totals is None:
            self._totals = [dict() for _ in range(self.order)]
        alpha = 1.0
        for n in range(self.order - 1, -1, -1):
            ctx = context[len(context) - n:] if n else ""
            bucket = self.counts[n].get(ctx)
            if bucket:
                total = self._totals[n].get(ctx)
                if total is None:
                    total = sum(bucket.values())
                    self._totals[n][ctx] = total
                cnt = bucket.get(char, 0.0)
                if cnt > 0:
                    return math.log10(alpha * cnt / total)
            alpha *= 0.4
        v = max(len(self.vocab), 2)
        return math.log10(self.add_k / v) + math.log10(max(alpha, 1e-12))

    # ------------------------------------------------- Kneser-Ney path
    def _prepare_kn(self) -> None:
        """Precompute KN tables: raw counts at the top order,
        continuation counts (distinct left-extension types) below, plus
        per-context (total, distinct) aggregates and per-order
        discounts."""
        O = self.order
        tables: List[Dict[str, Dict[str, float]]] = [None] * O  # type: ignore
        tables[O - 1] = {c: dict(b) for c, b in self.counts[O - 1].items()}
        for n in range(O - 2, -1, -1):
            cc: Dict[str, Dict[str, float]] = {}
            for ctx1, bucket in self.counts[n + 1].items():
                sub = ctx1[1:]
                d = cc.setdefault(sub, {})
                for c in bucket:
                    d[c] = d.get(c, 0.0) + 1.0
            tables[n] = cc
        agg: List[Dict[str, Tuple[float, int]]] = []
        discounts: List[float] = []
        for n in range(O):
            a: Dict[str, Tuple[float, int]] = {}
            n1 = n2 = 0
            for ctx, bucket in tables[n].items():
                a[ctx] = (float(sum(bucket.values())), len(bucket))
                for v in bucket.values():
                    if v == 1.0:
                        n1 += 1
                    elif v == 2.0:
                        n2 += 1
            agg.append(a)
            discounts.append(
                n1 / (n1 + 2.0 * n2) if (n1 + 2 * n2) > 0 else 0.75)
        self._kn = (tables, agg, discounts)

    def _kn_p_upto(self, ctx: str, char: str) -> float:
        """Interpolated-KN P(char | ctx) using levels 0..len(ctx) only
        (level-k context = the length-k suffix of ``ctx``); missing
        contexts are skipped (implicit backoff weight 1)."""
        tables, agg, discounts = self._kn
        p = 1.0 / max(len(self.vocab), 2)
        for n in range(len(ctx) + 1):
            c_n = ctx[len(ctx) - n:] if n else ""
            bucket = tables[n].get(c_n)
            if not bucket:
                continue
            total, distinct = agg[n][c_n]
            d = discounts[n]
            cnt = bucket.get(char, 0.0)
            p = max(cnt - d, 0.0) / total + d * distinct / total * p
        return p

    def _kn_logp(self, context: str, char: str) -> float:
        if self._kn is None:
            self._prepare_kn()
        ctx_full = (("^" * (self.order - 1) + context)[-(self.order - 1):]
                    if self.order > 1 else "")
        return math.log10(max(self._kn_p_upto(ctx_full, char), 1e-12))

    # ---------------------------------------------------------- ARPA io
    @classmethod
    def from_arpa(cls, path: str) -> "CharNgramLM":
        lm = cls()
        grams: Dict[int, Dict[str, Tuple[float, float]]] = {}
        order = 0
        with open(path, encoding="utf-8", errors="replace") as fh:
            section = 0
            for line in fh:
                line = line.rstrip("\n")
                m = re.match(r"\\(\d+)-grams:", line)
                if m:
                    section = int(m.group(1))
                    order = max(order, section)
                    grams.setdefault(section, {})
                    continue
                if not line or line.startswith("\\") or section == 0:
                    continue
                parts = line.split("\t")
                if len(parts) < 2:
                    continue
                logp = float(parts[0])
                gram = parts[1]
                backoff = float(parts[2]) if len(parts) > 2 else 0.0
                grams[section][gram] = (logp, backoff)
        lm.order = order
        lm.arpa = grams
        return lm

    def to_arpa(self, path: str) -> None:
        """Write the fitted counts model as an ARPA file.

        Completes the reference's LM lifecycle without the kenlm
        binaries (reference ngram/train_n_gram.sh runs lmplz -> .arpa;
        the python LM exports the same artifact format that its own
        ``from_arpa`` and kenlm's consumers read).
        For ``smoothing="stupid"`` probabilities are the add-k
        conditionals of each observed n-gram and contexts carry the
        stupid-backoff weight log10(0.4) (an approximation: the
        in-memory stupid path also discounts through *unobserved*
        context levels, which backoff-ARPA cannot express).

        For ``smoothing="kn"`` the export is EXACT: interpolated-KN
        n-gram conditionals with per-context backoff weights
        d_n * distinct / total — kenlm's own interpolated-ARPA
        convention — so ``from_arpa(to_arpa(lm))`` reproduces
        ``lm.logp`` bit-for-close on every in-vocab query (out-of-vocab
        chars hit the loader's -7 floor instead of the uniform base).
        """
        if not any(self.counts[0].values()):
            raise ValueError("to_arpa requires a fitted counts model")
        if self.smoothing == "kn":
            self._write_arpa_kn(path)
            return
        V = max(len(self.vocab), 1)
        bo = math.log10(0.4)
        sections: List[List[str]] = []
        for n in range(self.order):
            rows = []
            for ctx, bucket in sorted(self.counts[n].items()):
                total = sum(bucket.values())
                for c, cnt in sorted(bucket.items()):
                    logp = math.log10(
                        (cnt + self.add_k) / (total + self.add_k * V)
                    )
                    gram = " ".join(list(ctx) + [c])
                    # context grams of higher orders get a backoff field
                    tail = f"\t{bo:.6f}" if n + 1 < self.order else ""
                    rows.append(f"{logp:.6f}\t{gram}{tail}")
            sections.append(rows)
        self._write_arpa_sections(path, sections)

    def _write_arpa_kn(self, path: str) -> None:
        if self._kn is None:
            self._prepare_kn()
        tables, agg, discounts = self._kn
        # section m holds m-token entries: key -> [logp, backoff|None]
        entries: List[Dict[str, list]] = [dict() for _ in range(self.order)]
        for n in range(self.order):           # level n predicts gram len n+1
            for ctx, bucket in tables[n].items():
                for c in bucket:
                    key = " ".join(list(ctx) + [c])
                    logp = math.log10(
                        max(self._kn_p_upto(ctx, c), 1e-12))
                    entries[n].setdefault(key, [logp, None])[0] = logp
        # every level-m context (m>=1) carries its backoff weight on its
        # own m-gram entry (ARPA looks it up when an (m+1)-gram misses)
        for m in range(1, self.order):
            for ctx in tables[m]:
                total, distinct = agg[m][ctx]
                b = math.log10(
                    max(discounts[m] * distinct / total, 1e-12))
                key = " ".join(list(ctx))
                e = entries[m - 1].get(key)
                if e is None:
                    # context never predicted as a gram itself (e.g. a
                    # "^"-padding prefix): emit it with its own
                    # interpolated probability so the backoff has a home
                    logp = math.log10(
                        max(self._kn_p_upto(ctx[:-1], ctx[-1]), 1e-12))
                    e = entries[m - 1].setdefault(key, [logp, None])
                e[1] = b
        sections = []
        for n in range(self.order):
            rows = []
            for key, (logp, b) in sorted(entries[n].items()):
                tail = f"\t{b:.8f}" if b is not None else ""
                rows.append(f"{logp:.8f}\t{key}{tail}")
            sections.append(rows)
        self._write_arpa_sections(path, sections)

    @staticmethod
    def _write_arpa_sections(path: str, sections: List[List[str]]) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            fh.write("\\data\\\n")
            for n, rows in enumerate(sections):
                fh.write(f"ngram {n + 1}={len(rows)}\n")
            for n, rows in enumerate(sections):
                fh.write(f"\n\\{n + 1}-grams:\n")
                fh.write("\n".join(rows))
                fh.write("\n")
            fh.write("\n\\end\\\n")

    def _arpa_logp(self, context: str, char: str) -> float:
        toks = (list("^" * (self.order - 1)) + list(context))[-(self.order - 1):]
        acc = 0.0
        for n in range(min(len(toks) + 1, self.order), 0, -1):
            gram = " ".join(toks[len(toks) - (n - 1):] + [char])
            hit = self.arpa.get(n, {}).get(gram)
            if hit is not None:
                return hit[0] + acc
            ctx_gram = " ".join(toks[len(toks) - (n - 1):])
            bo = self.arpa.get(n - 1, {}).get(ctx_gram) if n > 1 else None
            acc += bo[1] if bo is not None else 0.0
        return -7.0 + acc


class LexiconTrie:
    """Prefix trie over word spellings — the hypothesis constraint of
    flashlight's lexicon decoder (reference
    prediction_helpers.py:76-91: ``ctc_decoder(lexicon=...)`` only
    proposes words spelled in the lexicon file)."""

    def __init__(self, words):
        self.words: set = set()
        self.children: Dict[str, set] = defaultdict(set)
        for w in words:
            w = w.strip()
            if not w:
                continue
            self.words.add(w)
            for i in range(len(w)):
                self.children[w[:i]].add(w[i])

    @classmethod
    def from_file(cls, path: str) -> "LexiconTrie":
        """flashlight lexicon format: 'word<TAB>w o r d |'
        (the file preprocessing.write_lexicon emits)."""
        words = []
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                w = line.split("\t", 1)[0].strip()
                if w:
                    words.append(w)
        return cls(words)

    def next_chars(self, prefix: str):
        return self.children.get(prefix, ())

    def is_word(self, prefix: str) -> bool:
        return prefix in self.words


def ctc_beam_search(
    probs: np.ndarray,          # (T, K+1) with blank at 0
    charset: Sequence[str],
    lm: Optional[CharNgramLM] = None,
    lm_weight: float = 0.25,
    beam: int = 16,
    logits_temperature: float = 1.0,
    lexicon: Optional[LexiconTrie] = None,
    return_score: bool = False,
):
    """CTC prefix beam search with char-LM shallow fusion.

    probs rows need not be normalized (the temperature path of
    prediction_helpers.py multiplies logits before sigmoid upstream).

    With ``lexicon`` set, hypotheses are constrained to trie prefixes
    and the final pick must be a COMPLETE lexicon word — the contract
    of flashlight's lexicon decoder (reference
    prediction_helpers.py:76-91). Returns None when no complete-word
    hypothesis survives (caller falls back to unconstrained).
    With ``return_score`` the return value is ``(text, score)``.
    """
    T, K1 = probs.shape
    logp = np.log(np.clip(probs, 1e-12, None)) * logits_temperature
    char_to_k = {c: i + 1 for i, c in enumerate(charset)}
    # beams: prefix -> (logp_blank, logp_nonblank, lm_score)
    beams: Dict[str, Tuple[float, float, float]] = {"": (0.0, -math.inf, 0.0)}
    NEG = -math.inf

    def logsumexp2(a, b):
        if a == NEG:
            return b
        if b == NEG:
            return a
        m = max(a, b)
        return m + math.log(math.exp(a - m) + math.exp(b - m))

    for t in range(T):
        new: Dict[str, Tuple[float, float, float]] = {}
        top_chars = np.argsort(-logp[t])[: max(beam, 8)]
        for prefix, (pb, pnb, lms) in beams.items():
            total = logsumexp2(pb, pnb)
            # blank
            cand = new.get(prefix, (NEG, NEG, lms))
            new[prefix] = (logsumexp2(cand[0], total + logp[t, 0]), cand[1], lms)
            if lexicon is None:
                ks = [int(k) for k in top_chars if k != 0]
            else:
                # grow only along the trie; the last char stays eligible
                # for the repeat (non-growing) extension
                ks = sorted(
                    {char_to_k[c] for c in lexicon.next_chars(prefix)
                     if c in char_to_k}
                    | ({char_to_k[prefix[-1]]}
                       if prefix and prefix[-1] in char_to_k else set())
                )
            for k in ks:
                c = charset[k - 1]
                lp = logp[t, k]
                if prefix and prefix[-1] == c:
                    # repeat char: extend nonblank only from blank state
                    cand = new.get(prefix, (NEG, NEG, lms))
                    new[prefix] = (cand[0], logsumexp2(cand[1], pnb + lp), lms)
                    if lexicon is not None and c not in lexicon.next_chars(prefix):
                        continue
                    np_prefix = prefix + c
                    add_lm = lm.logp(prefix, c) * lm_weight if lm else 0.0
                    cand2 = new.get(np_prefix, (NEG, NEG, lms + add_lm))
                    new[np_prefix] = (cand2[0], logsumexp2(cand2[1], pb + lp), lms + add_lm)
                else:
                    np_prefix = prefix + c
                    add_lm = lm.logp(prefix, c) * lm_weight if lm else 0.0
                    cand2 = new.get(np_prefix, (NEG, NEG, lms + add_lm))
                    new[np_prefix] = (cand2[0], logsumexp2(cand2[1], total + lp), lms + add_lm)
        scored = sorted(
            new.items(),
            key=lambda kv: -(logsumexp2(kv[1][0], kv[1][1]) + kv[1][2]),
        )
        beams = dict(scored[:beam])
    pool = beams.items()
    if lexicon is not None:
        pool = [kv for kv in pool if lexicon.is_word(kv[0])]
        if not pool:
            return (None, NEG) if return_score else None
    best = max(pool, key=lambda kv: logsumexp2(kv[1][0], kv[1][1]) + kv[1][2])
    if return_score:
        return best[0], logsumexp2(best[1][0], best[1][1]) + best[1][2]
    return best[0]


def _segment_greedy(labels: np.ndarray, charset: Sequence[str]) -> str:
    """CTC-collapse a frame-label segment (blank=0, chars shifted +1)."""
    out, prev = [], 0
    for l in labels:
        if l != 0 and l != prev:
            out.append(charset[l - 1])
        prev = l
    return "".join(out)


def rescore_line(
    frame_probs: np.ndarray,     # (T, K+1) x-sorted blank-synthesized probs
    greedy_text: str,
    charset: Sequence[str],
    lm: Optional[CharNgramLM],
    lm_weight: float = 0.25,
    beam: int = 16,
    no_uppercase_words: bool = True,
    no_digits: bool = False,
    no_dash: bool = True,
    lexicon: Optional[LexiconTrie] = None,
    lexicon_margin: float = 5.0,
) -> str:
    """Per-word LM rescoring with frame-level word splits (reference
    prediction_helpers.py get_word_per_word_pred_2 +
    get_input_split_indices, :48-73 and :125-224): the frame sequence is
    split at frames whose argmax is the space class; each word segment is
    independently beam-decoded with the LM, except gated words (first
    char uppercase / any digit / any dash keep the greedy output, as the
    reference's no_uppercase_words/no_digits/no_dash flags do).

    ``lexicon`` additionally constrains each non-gated word to the
    lexicon trie (flashlight's lexicon-decoder contract, reference
    prediction_helpers.py:76-91), with an OOV fallback: the
    unconstrained hypothesis wins when it out-scores the best in-lexicon
    word by more than ``lexicon_margin`` (log-space) — flashlight
    expresses the same tradeoff through its unk/word scores."""
    if lm is None:
        return greedy_text
    labels = frame_probs.argmax(-1)
    try:
        space_cls = charset.index(" ") + 1
    except ValueError:
        return ctc_beam_search(frame_probs, charset, lm, lm_weight, beam)

    def decode_segment(seg_probs: np.ndarray) -> str:
        free, free_score = ctc_beam_search(
            seg_probs, charset, lm, lm_weight, beam, return_score=True)
        if lexicon is None:
            return free
        lex, lex_score = ctc_beam_search(
            seg_probs, charset, lm, lm_weight, beam,
            lexicon=lexicon, return_score=True)
        if lex is None or lex_score + lexicon_margin < free_score:
            return free            # OOV segment: keep the open hypothesis
        return lex

    split_at = [-1] + [int(t) for t in np.where(labels == space_cls)[0]] + [len(labels)]
    pieces: list = []
    for i in range(len(split_at) - 1):
        s, e = split_at[i] + 1, split_at[i + 1]
        if e > s:
            seg = labels[s:e]
            gtext = _segment_greedy(seg, charset)
            first = next((charset[l - 1] for l in seg if l != 0), None)
            gated = (
                first is None
                or (no_uppercase_words and first.isupper())
                or (no_digits and first.isdigit())
                or (no_dash and "-" in gtext)
            )
            if gated:
                pieces.append(gtext)
            else:
                pieces.append(decode_segment(frame_probs[s:e]))
        if split_at[i + 1] < len(labels):
            pieces.append(" ")
    return "".join(pieces)
