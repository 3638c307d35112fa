#!/usr/bin/env python3
"""Digests of the no-lse decode kernels' outputs on the card.

Prints one JSON object: the card's SM count and the sha256 of the output
bytes of ``flash_decode`` and ``paged_flash_decode`` (without
``return_lse``) on ``chip_smoke.decode_digest_inputs`` (phase 2's decode
shapes and a shuffled block table, bf16 and fp32, inputs made on the host
from a numpy seed, so the same bits on any card).  ``chip_smoke.py``'s
phase 18 holds the kernels to ``DECODE_DIGESTS``, these digests read from
the tree before ``return_lse`` was added, by SM count.

    PYTHONPATH=src python scripts/decode_digests.py [--src build/<tree>/src]

With ``--src DIR`` (another tree's ``src``, e.g. a ``git archive`` of the
parent unpacked under ``build/``) it builds and runs that tree's kernels;
the inputs and the digests come from this tree's ``chip_smoke.py`` either
way.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.paged_decode_attention import paged_flash_decode
    if not torch.cuda.is_available():
        raise SystemExit("decode_digests: no CUDA device")
    build.build(("decode_attention", "paged_decode_attention"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # its repro_torch imports resolve to the tree loaded above
    device = torch.device("cuda")
    digests = chip_smoke.decode_digests(device, {"flash_decode": flash_decode,
                                                 "paged_flash_decode": paged_flash_decode})
    print(json.dumps({"src": args.src, "sms": build.sm_count(device.index or 0),
                      "card": torch.cuda.get_device_name(0), "digests": digests}))


if __name__ == "__main__":
    main()
