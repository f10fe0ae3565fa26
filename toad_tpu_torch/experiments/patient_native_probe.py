"""Host-side cost of patient bags: the native feed's segmented packing against
the numpy feed.

Counterpart of ``experiments/patient_native_probe.py``. No device work: it
measures reading, concatenation, padding and the wire's conversion only. The
disk-fed fixture's 16 ``.pt`` slides (8,192 x 1024 f32 each) are regrouped two
slides a patient by rewriting the manifest's ``case_id`` (with the ``csv``
module; the JAX probe uses pandas), and the 8 patient bags go through
``PatientBagSplit`` and ``BagBatcher`` at batch 4 and bucket 16,384, with no
prefetch thread, on the ``bfloat16`` and the ``int8`` wire, each with
``native`` on and off: one warm-up epoch (the page cache, the loader's
build), then the mean of 3.

Run: python -m toad_tpu_torch.experiments.patient_native_probe [--data_dir DIR]
Prints the JAX probe's lines: the bag count, then seconds per epoch a case.
``--device`` is taken as every probe takes it (the probes run on the card's
machine; ``cpu`` elsewhere), but nothing here runs on a device.
"""

from __future__ import annotations

import csv
import sys
import time
from pathlib import Path

from toad_tpu_torch.data.batching import BagBatcher
from toad_tpu_torch.data.synthetic import dummy_task, write_io_fixture
from toad_tpu_torch.data.wsi_dataset import PatientBagSplit, WSIBagDataset
from toad_tpu_torch.experiments import io_overlap_probe as iop
from toad_tpu_torch.experiments import resolve_device

SLIDES_PER_PATIENT = 2
BATCH, REPS = 4, 3
WIRES, NATIVE = ("bfloat16", "int8"), ("on", "off")


def patient_split(data_dir: Path) -> PatientBagSplit:
    """The fixture's slides, two a patient (``case_id`` PAT_0, PAT_0, PAT_1, ...)."""
    _, csv_path = write_io_fixture(data_dir, iop.N_SLIDES, iop.BAG_N, iop.DIM)
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        fields, rows = reader.fieldnames, list(reader)
    for i, row in enumerate(rows):
        row["case_id"] = f"PAT_{i // SLIDES_PER_PATIENT}"
    patients = data_dir / "patients.csv"
    with open(patients, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, lineterminator="\n")
        w.writeheader()
        w.writerows(rows)
    ds = WSIBagDataset(dummy_task(str(patients), name="bench_io_pat"), patients, data_dir=str(data_dir))
    return PatientBagSplit(ds.subset(range(iop.N_SLIDES)))


def batcher(split: PatientBagSplit, wire: str, native: str) -> BagBatcher:
    """The probe's batcher of one case: host only, no prefetch thread."""
    return BagBatcher(split, batch_size=BATCH, bucket_sizes=(SLIDES_PER_PATIENT * iop.BAG_N,), mode="sequential",
                      prefetch=0, transfer_dtype=wire, native=native)


def main(argv: list[str] | None = None) -> int:
    args = iop.probe_parser(__doc__).parse_args(argv)
    resolve_device(args.device)
    with iop.fixture_dir(args.data_dir) as data_dir:
        split = patient_split(data_dir)
        print(f"{len(split)} patient bags, {SLIDES_PER_PATIENT}x{iop.BAG_N}x{iop.DIM} f32 slides each", flush=True)
        for wire in WIRES:
            for native in NATIVE:
                for _ in batcher(split, wire, native):  # warm: the page cache, the loader's build
                    pass
                t0 = time.perf_counter()
                for _ in range(REPS):
                    for _ in batcher(split, wire, native):
                        pass
                dt = (time.perf_counter() - t0) / REPS
                print(f"wire={wire:9s} native={native:3s}: {dt:6.2f} s/epoch", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
