"""Paper §5.4 (Fig. 10): distributed 2D Heat stencil on a 4-node cluster.
Boundary-exchange (MPI) tasks are HIGH priority; an interfering matmul
kernel occupies 5 cores of node 0.

    PYTHONPATH=src python -m repro_torch.examples.heat_distributed

Twin of ``examples/heat_distributed.py``: its lines, on the port's copied
``core``.
"""
from ..core import (corun_socket, haswell_cluster, heat_dag,
                    make_scheduler, matmul_type, simulate)


def main() -> None:
    topo = haswell_cluster(4, 2, 10)
    print("distributed 2D Heat, 4 nodes x 20 cores, interferer on node 0\n")
    base = None
    for name in ("RWS", "RWSM-C", "DA", "DAM-C", "DAM-P"):
        sched = make_scheduler(name, topo, seed=1)
        dag = heat_dag(nodes=4, tiles_per_node=16, iterations=40)
        m = simulate(dag, sched,
                     background=[corun_socket(matmul_type(96), range(0, 5))])
        base = base or m.throughput
        print(f"{name:7s} throughput={m.throughput:8.0f} tasks/s "
              f"({m.throughput/base:.2f}x RWS)")
        base = base if name != "RWS" else m.throughput
    print("\npaper: DAM-C +76% vs RWS, +17% vs RWSM-C; moldability helps the "
          "MPI tasks via quieter caches.")


if __name__ == "__main__":
    main()
