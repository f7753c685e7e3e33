"""Paper §5.2: DVFS square-wave on the Denver cluster (2035/345 MHz, 5s+5s).

    PYTHONPATH=src python -m repro_torch.examples.dvfs_sim

Twin of ``examples/dvfs_sim.py``: its lines, on the port's copied
``core``.
"""
from ..core import (ALL_SCHEDULERS, copy_type, dvfs_denver,
                    make_scheduler, simulate, synthetic_dag, tx2)


def main() -> None:
    print("copy DAG (10000 tasks), DVFS 2035<->345 MHz on Denver, "
          "period 10 s\n")
    for P in (2, 4, 6):
        base = None
        row = []
        for name in ALL_SCHEDULERS:
            sched = make_scheduler(name, tx2(), seed=1)
            dag = synthetic_dag(copy_type(1024), parallelism=P,
                                total_tasks=10000)
            m = simulate(dag, sched, speed=dvfs_denver())
            base = base or m.throughput
            row.append(f"{name}={m.throughput:.0f}({m.throughput/base:.2f}x)")
        print(f"P={P}: " + "  ".join(row))
        base = None
    print("\npaper: DAM-C ~2.2x RWS on copy averaged over parallelism; DAM-P "
          "wins at low parallelism.")


if __name__ == "__main__":
    main()
