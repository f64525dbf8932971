"""Quickstart: a complete DOD-ETL pipeline on synthetic steelworks data,
end to end — the JAX package's ``examples/quickstart.py`` on the port: the
same four steps and prints. Runs on the CUDA card unless asked otherwise
(each transform is one ``transform_kpi`` launch; the first launch builds
the kernels with nvcc); ``--device cpu`` runs every kernel's plain
version:

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs.dod_etl import steelworks_config
from repro_torch.core import DODETLPipeline, SourceDatabase
from repro_torch.data.sampler import SamplerConfig, SteelworksSampler


def main(argv: Optional[Sequence[str]] = None) -> DODETLPipeline:
    """Runs the four steps and returns the drained pipeline."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    # 1. a source database with a CDC log, fed by the plant simulator
    cfg = steelworks_config(n_partitions=8)
    source = SourceDatabase()
    sampler = SteelworksSampler(cfg, SamplerConfig(
        records_per_table=5_000, n_equipment=8, late_master_frac=0.05))
    sampler.generate(source)
    print(f"source: {source.log.size()} change records in the CDC log")

    # 2. DOD-ETL: Change Tracker -> Message Queue -> Stream Processor
    pipe = DODETLPipeline(cfg, source, n_workers=4, device=args.device)
    extracted = pipe.extract()
    dump_s = pipe.bootstrap_caches()
    print(f"extracted {extracted} records (log-based CDC; "
          f"{source.lookup_count} production-table queries)")
    print(f"cache bootstrap: {dump_s * 1e3:.1f} ms (Fig. 4 overhead)")

    # 3. stream to completion; late records ride the operational buffer
    done = pipe.run_to_completion()
    late = sum(w.transformer.records_late for w in pipe.workers)
    print(f"transformed {done} facts ({late} arrived before their master "
          f"data and were retried via the buffer)")

    # 4. near-real-time OLAP: the star schema is queryable immediately
    for eq in range(3):
        kpis = pipe.warehouse.query_oee(eq)
        print(f"  equipment {eq}: OEE={kpis['oee']:.3f} "
              f"A={kpis['availability']:.3f} P={kpis['performance']:.3f} "
              f"Q={kpis['quality']:.3f} ({int(kpis['rows'])} grains)")
    print(f"warehouse rows: {pipe.warehouse.rows_loaded}; "
          f"source look-backs by DOD-ETL: {source.lookup_count} (always 0)")
    return pipe


if __name__ == "__main__":
    main()
