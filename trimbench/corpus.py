"""Seeded read pairs for the benchmark's inputs, made with torch on any device.

The quality model is a frozen copy of the port's ``utils/corpus.py``
(``make_reads``): each read has a level, a quadratic 3' decay and Gaussian
noise, and a share of reads has a 3' crash, a low start or low quality
throughout; qualities may be snapped to a set of bins (NovaSeq's RTA3).
The copy is extended, and only the copy:

* the model's numbers come from the configuration file, and read 2 may
  override them (a MiSeq read 2 decays faster);
* reads carry Illumina names (``@<prefix>:<tile>:<x>:<y> <mate>:<comment>``),
  the mates of a pair sharing their cluster's coordinates;
* every block of a sample is seeded from the run's seed, the sample and the
  block alone, so the reference can make any block again after the window;
* a sample's pair counts are a fixed set for every seed: the seed orders
  the samples and draws the reads, never how much work there is;
* a single-end configuration (one entry in ``read_length``) draws mate 1
  alone, as a pair's mate 1 is drawn.

Every read of a mate has the configuration's length and every name of a
sample the same width, so a block's FASTQ text is one ``[reads, record]``
array made in a few large calls.
"""

from __future__ import annotations

import hashlib
import math
import statistics
from typing import Dict, List

import torch

BLOCK_PAIRS = 1 << 17
WARMUP = "warmup"  # the sample index of the harness's warm-up file
ACGT = torch.tensor(list(b"ACGT"), dtype=torch.uint8)
NEWLINE = 10
PLUS_LINE = (10, 43, 10)  # "\n+\n" between a read's bases and its qualities


def sub_seed(*parts) -> int:
    """A 63-bit seed drawn from ``parts`` (the run's seed first)."""
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def _generator(device, *parts) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(*parts))
    return gen


def _uniform(gen, shape, bounds, device) -> torch.Tensor:
    lo, hi = bounds
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def mate_reads(gen: torch.Generator, n: int, length: int, model: dict,
               offset: int, device) -> tuple:
    """``(seq, qual)``: uint8 ``[n, length]`` bases and quality chars."""
    pos = torch.arange(length, device=device)[None, :]
    frac = pos / length
    level = _uniform(gen, (n, 1), model["level"], device)
    noise = torch.randn((n, length), generator=gen, device=device)
    q = level - model["decay"] * frac ** 2 + model["noise_sd"] * noise
    kind = torch.rand((n, 1), generator=gen, device=device)
    crash_end = model["crash_share"]
    low_end = crash_end + model["low_start_share"]
    all_low_end = low_end + model["all_low_share"]
    crash_at = (length * _uniform(gen, (n, 1), model["crash_at"], device)).floor()
    low_len = (length * _uniform(gen, (n, 1), model["low_start_len"],
                                 device)).floor() + 1
    # the three kinds are exclusive, so one draw serves each one's values
    u = torch.rand((n, length), generator=gen, device=device)

    def span(bounds):
        return bounds[0] + (bounds[1] - bounds[0]) * u

    crash = (kind < crash_end) & (pos >= crash_at)
    low = (kind >= crash_end) & (kind < low_end) & (pos < low_len)
    all_low = (kind >= low_end) & (kind < all_low_end)
    q = torch.where(crash, span(model["crash_q"]), q)
    q = torch.where(low, span(model["low_start_q"]), q)
    q = torch.where(all_low.expand(n, length), span(model["all_low_q"]), q)
    q = q.round().clamp(0, model["max_q"])
    if model.get("bins"):
        bins = torch.tensor(model["bins"], dtype=q.dtype, device=device)
        q = bins[(q[..., None] - bins).abs().argmin(-1)]
    qual = (q + offset).to(torch.uint8)
    bases = torch.randint(0, 4, (n, length), generator=gen, device=device)
    return ACGT.to(device)[bases], qual


def _digits(values: torch.Tensor, width: int) -> torch.Tensor:
    powers = 10 ** torch.arange(width - 1, -1, -1, device=values.device)
    return ((values[:, None] // powers) % 10 + 48).to(torch.uint8)


def _text(s: str, n: int, device) -> torch.Tensor:
    row = torch.tensor(list(s.encode()), dtype=torch.uint8, device=device)
    return row[None, :].expand(n, row.numel())


def name_width(names: dict) -> Dict[str, int]:
    """Digits of each coordinate field; its range must keep them fixed."""
    widths = {}
    for key in ("tile", "x", "y"):
        lo, hi = names[key]
        if len(str(lo)) != len(str(hi)) or lo > hi:
            raise ValueError(f"names.{key} {names[key]} must keep one width")
        widths[key] = len(str(hi))
    return widths


def read_names(gen: torch.Generator, first: int, n: int, total: int,
               names: dict, sample: int, device) -> tuple:
    """uint8 ``[n, width]`` names of mate 1 and mate 2 of pairs
    ``first .. first + n`` of a sample of ``total`` pairs.  Tiles rise
    along the file, as a run writes them; x and y are drawn."""
    widths = name_width(names)
    idx = first + torch.arange(n, device=device)
    t_lo, t_hi = names["tile"]
    tile = t_lo + idx * (t_hi - t_lo + 1) // max(total, 1)
    x = torch.randint(names["x"][0], names["x"][1] + 1, (n,), generator=gen,
                      device=device)
    y = torch.randint(names["y"][0], names["y"][1] + 1, (n,), generator=gen,
                      device=device)
    coords = [_text("@" + names["prefix"] + ":", n, device),
              _digits(tile, widths["tile"]), _text(":", n, device),
              _digits(x, widths["x"]), _text(":", n, device),
              _digits(y, widths["y"])]
    comment = names["comment"].format(sample=sample + 1)
    return tuple(torch.cat(coords + [_text(f" {mate}:{comment}", n, device)],
                           dim=1) for mate in (1, 2))


def mate_model(cfg: dict, mate: int) -> dict:
    model = dict(cfg["quality"])
    if mate == 2:
        model.update(cfg.get("mate2_quality", {}))
    return model


def mates(cfg: dict) -> int:
    """2 for a paired-end configuration, 1 for a single-end one: one
    entry of ``read_length`` per mate."""
    return len(cfg["read_length"])


def pair_block(cfg: dict, seed: int, sample, block: int, total: int,
               device) -> dict:
    """Pairs ``block * BLOCK_PAIRS ..`` of a sample of ``total`` pairs:
    ``name1, seq1, qual1, name2, seq2, qual2`` (uint8 rows), or, for a
    single-end configuration, mate 1's alone, drawn as a pair's mate 1 is.
    ``sample`` is the sample's index, or ``WARMUP``."""
    first = block * BLOCK_PAIRS
    n = min(BLOCK_PAIRS, total - first)
    offset = cfg["qual_offset"]
    out = {}
    for mate in range(1, mates(cfg) + 1):
        gen = _generator(device, seed, sample, block, mate)
        out[f"seq{mate}"], out[f"qual{mate}"] = mate_reads(
            gen, n, cfg["read_length"][mate - 1], mate_model(cfg, mate),
            offset, device)
    gen = _generator(device, seed, sample, block, "names")
    number = sample if isinstance(sample, int) else 0
    names = read_names(gen, first, n, total, cfg["names"], number, device)
    for mate in range(1, mates(cfg) + 1):
        out[f"name{mate}"] = names[mate - 1]
    return out


def blocks(total: int) -> range:
    return range(-(-total // BLOCK_PAIRS))


def fastq_text(name: torch.Tensor, seq: torch.Tensor,
               qual: torch.Tensor) -> torch.Tensor:
    """The records as FASTQ text: one flat uint8 tensor."""
    n = seq.shape[0]
    dev = seq.device
    newline = torch.full((n, 1), NEWLINE, dtype=torch.uint8, device=dev)
    plus = _text(bytes(PLUS_LINE).decode(), n, dev)
    return torch.cat([name, newline, seq, plus, qual, newline], dim=1).reshape(-1)


def sample_pairs(cfg: dict, scale: float = 1.0) -> List[int]:
    """Pairs in each of the configuration's samples: ``pairs`` each, or,
    with ``depth``, the quantiles ``(i + 0.5) / samples`` of a log-normal
    of that mean and spread, so every seed has the same set of sizes."""
    k = cfg["samples"]
    if "depth" in cfg:
        mean, sigma = cfg["depth"]["mean_pairs"], cfg["depth"]["sigma"]
        z = statistics.NormalDist()
        loc = math.log(mean) - sigma * sigma / 2
        pairs = [math.exp(loc + sigma * z.inv_cdf((i + 0.5) / k))
                 for i in range(k)]
    else:
        pairs = [cfg["pairs"]] * k
    return [max(1, round(p * scale)) for p in pairs]


def files(cfg: dict, mix: dict, scale: float = 1.0) -> List[List[tuple]]:
    """The input files of a cell, each the ``(sample, pairs)`` written into
    it one after another: one file per sample, or with the traffic's
    ``pool`` every sample in index order in one file, byte for byte the
    concatenation of the per-sample files."""
    sizes = list(enumerate(sample_pairs(cfg, scale)))
    return [sizes] if mix.get("pool") else [[s] for s in sizes]


def plate_order(samples: int, seed: int) -> List[int]:
    """The order in which the samples are trimmed, drawn from the seed."""
    gen = _generator("cpu", seed, "order")
    return torch.randperm(samples, generator=gen).tolist()
