"""Observed-peak telemetry ingestion (a stdlib copy of ``repro.obs.ingest``).

Accepts ``GPUMemorySnapshot``-shaped observed-peak records (the ktrdr
monitoring idiom: per-device allocated/reserved/total MB plus
utilization) keyed by ``(model digest, config family)`` — the same
content digest the trace cache uses (``fn_digest``) and the same
structural family fingerprint the degradation ladder uses
(``request_family``) — and persists estimate-vs-observed residuals as
crash-safe JSONL next to the TraceStore. This is the substrate the
feedback calibration reads (residuals turned into calibrated
estimates with confidence intervals); this module makes sure the
records exist and survive restarts.

Also usable as a CLI::

    python -m repro_torch.obs.ingest --dir STORE/telemetry \\
        --model-digest abc123 --family fam0 \\
        --estimate-bytes 1000000 --observed-mb 1.2
    python -m repro_torch.obs.ingest --dir STORE/telemetry --summary
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from .audit import AuditLog

MB = 2 ** 20


@dataclasses.dataclass
class GPUMemorySnapshot:
    """One observed device-memory sample (ktrdr monitoring shape)."""

    timestamp: float
    device_id: int = 0
    allocated_mb: float = 0.0
    reserved_mb: float = 0.0
    total_mb: float = 0.0
    free_mb: float = 0.0
    utilization_percent: float = 0.0
    temperature_celsius: float | None = None
    power_usage_watts: float | None = None

    @property
    def reserved_bytes(self) -> int:
        return int(self.reserved_mb * MB)

    @property
    def allocated_bytes(self) -> int:
        return int(self.allocated_mb * MB)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "GPUMemorySnapshot":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


class TelemetryIngestor:
    """Persist estimate-vs-observed residual records, one JSONL line
    per observation, with the audit log's torn-tail recovery."""

    def __init__(self, directory: str):
        self.log = AuditLog(directory, name="residuals")

    def ingest(self, model_digest: str, config_family: str,
               estimate_bytes: int,
               snapshot: GPUMemorySnapshot | None = None,
               observed_bytes: int | None = None) -> dict:
        """Record one observed peak against its estimate. The observed
        peak is the snapshot's *reserved* bytes (what the allocator
        actually held — the quantity xMem estimates) unless
        ``observed_bytes`` is given explicitly."""
        if observed_bytes is None:
            if snapshot is None:
                raise ValueError(
                    "need a snapshot or explicit observed_bytes")
            observed_bytes = snapshot.reserved_bytes
        rec = {
            "kind": "residual",
            "model_digest": model_digest,
            "config_family": config_family,
            "estimate_bytes": int(estimate_bytes),
            "observed_bytes": int(observed_bytes),
            "residual_bytes": int(observed_bytes) - int(estimate_bytes),
            "ratio": (observed_bytes / estimate_bytes
                      if estimate_bytes else None),
        }
        if snapshot is not None:
            rec["snapshot"] = snapshot.to_dict()
        return self.log.append(rec)

    def residuals(self, model_digest: str | None = None,
                  config_family: str | None = None) -> list[dict]:
        out = []
        for rec in self.log.records(kind="residual"):
            if model_digest is not None and \
                    rec.get("model_digest") != model_digest:
                continue
            if config_family is not None and \
                    rec.get("config_family") != config_family:
                continue
            out.append(rec)
        return out

    def summary(self) -> dict:
        """Per-(model digest, config family) residual statistics —
        the shape a calibration pass consumes."""
        groups: dict = {}
        for rec in self.log.records(kind="residual"):
            key = f"{rec.get('model_digest')}/{rec.get('config_family')}"
            g = groups.setdefault(
                key, {"n": 0, "sum_residual": 0, "sum_ratio": 0.0,
                      "max_ratio": None, "min_ratio": None})
            g["n"] += 1
            g["sum_residual"] += rec.get("residual_bytes", 0)
            ratio = rec.get("ratio")
            if ratio is not None:
                g["sum_ratio"] += ratio
                if g["max_ratio"] is None or ratio > g["max_ratio"]:
                    g["max_ratio"] = ratio
                if g["min_ratio"] is None or ratio < g["min_ratio"]:
                    g["min_ratio"] = ratio
        out = {}
        for key, g in groups.items():
            n = g["n"]
            out[key] = {
                "n": n,
                "mean_residual_bytes": g["sum_residual"] / n,
                "mean_ratio": g["sum_ratio"] / n if n else None,
                "max_ratio": g["max_ratio"],
                "min_ratio": g["min_ratio"],
            }
        return out

    def stats(self) -> dict:
        return self.log.stats()

    def close(self) -> None:
        self.log.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Ingest observed GPU-memory peaks and store "
                    "estimate-vs-observed residuals")
    p.add_argument("--dir", required=True,
                   help="telemetry directory (e.g. STORE/telemetry)")
    p.add_argument("--summary", action="store_true",
                   help="print per-(digest, family) residual summary")
    p.add_argument("--model-digest", help="content digest of the model"
                                          " fn (see fn_digest)")
    p.add_argument("--family", help="config family fingerprint (see "
                                    "request_family)")
    p.add_argument("--estimate-bytes", type=int,
                   help="xMem estimated peak in bytes")
    p.add_argument("--observed-bytes", type=int,
                   help="observed peak in bytes")
    p.add_argument("--observed-mb", type=float,
                   help="observed reserved MB (GPUMemorySnapshot "
                        "shape)")
    p.add_argument("--snapshot-json",
                   help="path to a GPUMemorySnapshot JSON file")
    args = p.parse_args(argv)

    ing = TelemetryIngestor(args.dir)
    try:
        if args.summary:
            print(json.dumps(ing.summary(), indent=2, sort_keys=True))
            return 0
        if not (args.model_digest and args.family
                and args.estimate_bytes is not None):
            p.error("ingestion needs --model-digest, --family and "
                    "--estimate-bytes (or use --summary)")
        snapshot = None
        observed = args.observed_bytes
        if args.snapshot_json:
            with open(args.snapshot_json) as f:
                snapshot = GPUMemorySnapshot.from_dict(json.load(f))
        elif args.observed_mb is not None:
            snapshot = GPUMemorySnapshot(timestamp=0.0,
                                         reserved_mb=args.observed_mb)
        rec = ing.ingest(args.model_digest, args.family,
                         args.estimate_bytes, snapshot=snapshot,
                         observed_bytes=observed)
        print(json.dumps(rec, sort_keys=True))
        return 0
    finally:
        ing.close()


if __name__ == "__main__":
    sys.exit(main())
