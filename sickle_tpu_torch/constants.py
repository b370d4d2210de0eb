"""Shared constants for sickle-tpu.

Quality-encoding tables reproduce the reference's semantics
(the reference's src/sickle.h:62-91): each encoding has an ASCII offset and a
valid [min, max] ASCII range.  The SOLEXA row is a linear approximation, same
as the reference.  The PHRED row exists in the reference table but is not
reachable from the CLI (only sanger/illumina/solexa are accepted,
the reference's src/trim_single.cpp:104-115); we keep it for table parity.
"""

from __future__ import annotations

import enum


class QualityType(enum.IntEnum):
    PHRED = 0
    SANGER = 1
    SOLEXA = 2
    ILLUMINA = 3


TYPE_NAMES = {
    QualityType.PHRED: "Phred",
    QualityType.SANGER: "Sanger",
    QualityType.SOLEXA: "Solexa",
    QualityType.ILLUMINA: "Illumina",
}

# name accepted by the CLI -> QualityType
CLI_QUALITY_TYPES = {
    "sanger": QualityType.SANGER,
    "solexa": QualityType.SOLEXA,
    "illumina": QualityType.ILLUMINA,
}

# offset, min ascii, max ascii (reference src/sickle.h:85-91)
QUALITY_CONSTANTS = {
    QualityType.PHRED: (0, 4, 60),
    QualityType.SANGER: (33, 33, 126),
    QualityType.SOLEXA: (64, 58, 112),
    QualityType.ILLUMINA: (64, 64, 110),
}


def quality_offset(qualtype: QualityType) -> int:
    return QUALITY_CONSTANTS[qualtype][0]


def quality_min(qualtype: QualityType) -> int:
    return QUALITY_CONSTANTS[qualtype][1]


def quality_max(qualtype: QualityType) -> int:
    return QUALITY_CONSTANTS[qualtype][2]


def lowest_quality_char(qualtype: QualityType) -> bytes:
    """ASCII char of the lowest valid quality for an encoding.

    Used by pe -M mode: failed reads become a record with seq "N" and this
    quality char (reference README.md:116-121; upstream sickle 1.33).
    """
    return bytes([quality_min(qualtype)])


class Compat(str, enum.Enum):
    """Behavior switch where the reference fork and upstream 1.33 disagree.

    * ``V133`` (default): upstream sickle 1.33 — the FASTQ '+' comment line is
      rewritten to a bare ``+`` on output, and -n N-truncation looks for 'N'
      before 'n'.
    * ``FORK``: the pentalpha fork — comment line is emitted verbatim
      (the reference's src/trim_single.cpp:395) and N-truncation looks for
      'n' before 'N' (the reference's src/trim.cpp:86-95, intended semantics
      of the buggy code there).
    """

    V133 = "1.33"
    FORK = "fork"


DEFAULT_QUAL_THRESHOLD = 20  # reference src/trim_single.cpp:70
DEFAULT_LENGTH_THRESHOLD = 20  # reference src/trim_single.cpp:69

PROGRAM_NAME = "sickle"
VERSION = "1.33"
AUTHORS = "Nikhil Joshi, UC Davis Bioinformatics Core\n"
