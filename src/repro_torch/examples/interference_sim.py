"""Paper §5.1 in one script: co-running interference on the TX2 topology.

    PYTHONPATH=src python -m repro_torch.examples.interference_sim

Reproduces the qualitative content of Figures 4-6: all seven schedulers
run the same matmul DAG while a background matmul chain occupies core 0.

Twin of ``examples/interference_sim.py``: its lines, on the port's copied
``core``.
"""
from ..core import (ALL_SCHEDULERS, corun_chain, make_scheduler,
                    matmul_type, simulate, synthetic_dag, tx2)


def main() -> None:
    P, TOTAL = 2, 8000
    print(f"matmul DAG, parallelism {P}, {TOTAL} tasks, co-runner on core 0\n")
    print(f"{'sched':8s} {'tasks/s':>10s} {'vs RWS':>7s} {'crit@C0':>8s} "
          f"{'top place':>12s}")
    base = None
    for name in ALL_SCHEDULERS:
        sched = make_scheduler(name, tx2(), seed=1)
        dag = synthetic_dag(matmul_type(64), parallelism=P, total_tasks=TOTAL)
        m = simulate(dag, sched, background=[corun_chain(matmul_type(64), 0)])
        base = base or m.throughput
        pp = m.priority_placement()
        on_c0 = sum(v for k, v in pp.items() if k.startswith("(C0"))
        top = max(pp.items(), key=lambda kv: kv[1])
        print(f"{name:8s} {m.throughput:10.0f} {m.throughput/base:6.2f}x "
              f"{on_c0*100:7.1f}% {top[0]:>9s}:{top[1]*100:.0f}%")
    print("\npaper: DAM-C up to 3.5x RWS; dynamic schedulers place ~0-2% of "
          "critical tasks\non the interfered core while FA pins 50% there.")


if __name__ == "__main__":
    main()
