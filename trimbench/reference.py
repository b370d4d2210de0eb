"""The plain reference: sickle 1.33's windowed trim, ``se`` and ``pe``.

Plain PyTorch, on any device, written from sickle 1.33's rules
(``src/sliding_window.c``, ``src/trim_single.c`` and ``src/trim_paired.c``)
and nothing of the program under test.  It works from the arrays the corpus
made, the same the harness wrote into the program's input files, and
writes the outputs and the summary that ``sickle se -f -o`` and
``sickle pe -f -r -o -p -s`` print under the default ``--compat`` (1.33:
the ``+`` line bare).

The rule, per read of length ``L`` and threshold ``q``: the window is
``int(0.1 * L)`` positions, or the whole read when that is 0.  Scanning
windows left to right, the first whose quality sum reaches ``q`` times its
size starts the read at its first position of quality ``q`` or more; the
first later window whose sum falls below cuts the read at its first
position of quality under ``q``.  A read shorter than ``-l``, with no
window reaching ``q``, or shorter than ``-l`` once trimmed, is discarded.
``se`` writes every read that stays to ``-o``, in input order.  A pair
whose mates both stay goes to ``-o`` and ``-p``; one whose single mate
stays puts it in ``-s``, in pair order.

``drop_bit`` is the control: the same rule on qualities carried with one
bit fewer (each Phred value rounded down to an even one), the shortcut a
lossy quality wire would take.
"""

from __future__ import annotations

import collections
from typing import List

import torch

from . import corpus

NEWLINE = 10
PLUS = 43
DEFAULT_Q = 20  # sickle's -q
DEFAULT_L = 20  # sickle's -l


def thresholds(flags) -> tuple:
    """``(q, l)`` that the command-line ``flags`` set, or sickle's defaults."""
    given = dict(zip(flags, list(flags)[1:]))
    return int(given.get("-q", DEFAULT_Q)), int(given.get("-l", DEFAULT_L))


def _first(mask: torch.Tensor, none: int) -> torch.Tensor:
    """Index of each row's first True, or ``none``."""
    return torch.where(mask.any(1), mask.to(torch.int8).argmax(1),
                       torch.full_like(mask[:, 0], none, dtype=torch.int64))


def cuts(qual: torch.Tensor, offset: int, q: int, min_len: int,
         drop_bit: bool = False) -> tuple:
    """``(five, three)`` int64 per read of uint8 ``qual [n, L]``, every
    read ``L`` long; ``three == -1`` discards the read."""
    n, L = qual.shape
    phred = qual.to(torch.int64) - offset
    if drop_bit:
        phred = phred & ~1
    discard = torch.full((n,), -1, dtype=torch.int64, device=qual.device)
    if L < min_len or L == 0:
        return discard, discard
    w = int(0.1 * L) or L
    cum = torch.nn.functional.pad(phred.cumsum(1), (1, 0))
    sums = cum[:, w:] - cum[:, :L - w + 1]  # window i covers i .. i + w - 1
    starts = torch.arange(L - w + 1, device=qual.device)[None, :]
    pos = torch.arange(L, device=qual.device)[None, :]
    rise = sums >= q * w
    i5 = _first(rise, L)
    five = _first((phred >= q) & (pos >= i5[:, None]), L)
    i3 = _first((sums < q * w) & (starts > i5[:, None]), L)
    three = torch.where(i3 < L, _first((phred < q) & (pos >= i3[:, None]), L),
                        torch.full_like(i3, L))
    keep = rise.any(1) & (three - five >= min_len)
    return torch.where(keep, five, discard), torch.where(keep, three, discard)


def records(name: torch.Tensor, seq: torch.Tensor, qual: torch.Tensor,
            five: torch.Tensor, three: torch.Tensor) -> torch.Tensor:
    """FASTQ text of the reads trimmed to ``[five, three)``: a flat uint8
    tensor of ``name \\n seq \\n + \\n qual \\n`` records, in row order."""
    n, width = name.shape
    L = seq.shape[1]
    if n == 0:
        return torch.empty(0, dtype=torch.uint8, device=seq.device)
    cols = torch.arange(width + 2 * L + 5, device=seq.device)[None, :]
    k = (three - five)[:, None]
    seq_at = width + 1
    qual_at = seq_at + k + 3
    take_seq = (five[:, None] + cols - seq_at).clamp(0, L - 1)
    take_qual = (five[:, None] + cols - qual_at).clamp(0, L - 1)
    name_wide = torch.nn.functional.pad(name, (0, 2 * L + 5))
    out = torch.where(cols < width, name_wide, NEWLINE)
    out = torch.where((cols >= seq_at) & (cols < seq_at + k),
                      seq.gather(1, take_seq), out)
    out = torch.where(cols == seq_at + k + 1, PLUS, out)
    out = torch.where((cols >= qual_at) & (cols < qual_at + k),
                      qual.gather(1, take_qual), out)
    return out[cols <= qual_at + k].to(torch.uint8)


def _pad_to(t: torch.Tensor, width: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, width - t.shape[1]))


def trim_single(block: dict, offset: int, q: int, min_len: int,
                drop_bit: bool = False) -> tuple:
    """``(out, counters)`` of one block of single reads: a flat uint8
    tensor and the summary's counts."""
    five, three = cuts(block["qual1"], offset, q, min_len, drop_bit)
    keep = three >= 0
    out = records(block["name1"][keep], block["seq1"][keep],
                  block["qual1"][keep], five[keep], three[keep])
    kept = int(keep.sum())
    return out, dict(total=int(keep.numel()), kept=kept,
                     discarded=int(keep.numel()) - kept)


def trim_pairs(block: dict, offset: int, q: int, min_len: int,
               drop_bit: bool = False) -> tuple:
    """``(out1, out2, singles, counters)`` of one block of pairs: three
    flat uint8 tensors and the summary's counts."""
    f1, t1 = cuts(block["qual1"], offset, q, min_len, drop_bit)
    f2, t2 = cuts(block["qual2"], offset, q, min_len, drop_bit)
    k1, k2 = t1 >= 0, t2 >= 0
    both = k1 & k2
    out1 = records(block["name1"][both], block["seq1"][both],
                   block["qual1"][both], f1[both], t1[both])
    out2 = records(block["name2"][both], block["seq2"][both],
                   block["qual2"][both], f2[both], t2[both])
    one = k1 ^ k2
    first = k1[one][:, None]
    wide = max(block["seq1"].shape[1], block["seq2"].shape[1])

    def pick(key, width=None):
        a, b = block[f"{key}1"][one], block[f"{key}2"][one]
        if width:
            a, b = _pad_to(a, width), _pad_to(b, width)
        return torch.where(first, a, b)

    singles = records(pick("name"), pick("seq", wide), pick("qual", wide),
                      torch.where(first[:, 0], f1[one], f2[one]),
                      torch.where(first[:, 0], t1[one], t2[one]))
    s1 = int((k1 & ~k2).sum())
    s2 = int((k2 & ~k1).sum())
    dp = 2 * int((~k1 & ~k2).sum())
    n = int(k1.numel())
    counters = dict(total=2 * n, kept_p=2 * int(both.sum()), kept_s1=s1,
                    kept_s2=s2, discard_p=dp, discard_s1=s2, discard_s2=s1)
    return out1, out2, singles, counters


def summary(r1: str, r2: str, c: dict) -> str:
    """What ``sickle pe`` prints for two mate files."""
    return (
        f"\nPE forward file: {r1}\nPE reverse file: {r2}\n"
        f"\nTotal input FastQ records: {c['total']} ({c['total'] // 2} pairs)\n"
        f"\nFastQ paired records kept: {c['kept_p']} ({c['kept_p'] // 2} pairs)\n"
        f"FastQ single records kept: {c['kept_s1'] + c['kept_s2']} "
        f"(from PE1: {c['kept_s1']}, from PE2: {c['kept_s2']})\n"
        f"FastQ paired records discarded: {c['discard_p']} "
        f"({c['discard_p'] // 2} pairs)\n"
        f"FastQ single records discarded: {c['discard_s1'] + c['discard_s2']} "
        f"(from PE1: {c['discard_s1']}, from PE2: {c['discard_s2']})\n\n"
    )


def summary_se(r1: str, c: dict) -> str:
    """What ``sickle se`` prints for one input file."""
    return (f"\nSE input file: {r1}\n\n"
            f"Total FastQ records: {c['total']}\n"
            f"FastQ records kept: {c['kept']}\n"
            f"FastQ records discarded: {c['discarded']}\n\n")


def summary_of(paths: List[str], c: dict) -> str:
    """The summary of a call on ``paths``: ``se``'s for one input file,
    ``pe``'s for two mate files."""
    return summary_se(paths[0], c) if len(paths) == 1 else summary(*paths, c)


def expected(cfg: dict, flags, seed: int, parts, device,
             drop_bit: bool = False) -> tuple:
    """``(outputs, counts)`` of one input file made of ``parts``, each
    ``(sample, pairs)`` as ``corpus.files`` gives them: the outputs
    (``se``'s one, ``pe``'s three) as bytes, each the concatenation of the
    parts' in order, and the counts summed."""
    q, min_len = thresholds(flags)
    single = corpus.mates(cfg) == 1
    parts_out: List[List[bytes]] = [[] for _ in range(1 if single else 3)]
    counts = collections.Counter()
    for sample, pairs in parts:
        for b in corpus.blocks(pairs):
            block = corpus.pair_block(cfg, seed, sample, b, pairs, device)
            if single:
                out, c = trim_single(block, cfg["qual_offset"], q, min_len,
                                     drop_bit)
                outs = [out]
            else:
                *outs, c = trim_pairs(block, cfg["qual_offset"], q, min_len,
                                      drop_bit)
            for acc, o in zip(parts_out, outs):
                acc.append(o.cpu().numpy().tobytes())
            counts.update(c)
    return [b"".join(p) for p in parts_out], dict(counts)
