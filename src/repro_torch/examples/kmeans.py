"""Paper §5.4: K-means as a dynamic DAG on the symmetric Haswell platform
with a mid-run interference window on socket 0 (Fig. 9).

    PYTHONPATH=src python -m repro_torch.examples.kmeans

Twin of ``examples/kmeans.py``: its lines, on the port's copied
``core``.
"""
import numpy as np

from ..core import (corun_socket, haswell, kmeans_dag, make_scheduler,
                    matmul_type, simulate)


def main() -> None:
    topo = haswell(2, 8)
    WINDOW = (0.15, 0.60)
    print("K-means, 2M points, 24 chunks/iter, interference on socket-0 cores "
          f"during t=[{WINDOW[0]}, {WINDOW[1]}]s\n")
    for name in ("RWS", "RWSM-C", "DA", "DAM-C", "DAM-P"):
        sched = make_scheduler(name, topo, seed=1)
        dag = kmeans_dag(n_points=2_000_000, dims=32, k=16, n_chunks=24,
                         iterations=60)
        m = simulate(dag, sched,
                     background=[corun_socket(matmul_type(96), range(0, 5),
                                              t_start=WINDOW[0],
                                              t_end=WINDOW[1])])
        red = [k for k in m.per_type_mean_duration()
               if k.startswith("kmeans_reduce")][0]
        its = np.array(m.iteration_times(red))
        print(f"{name:7s} makespan={m.makespan:6.3f}s  iter mean="
              f"{its.mean()*1e3:6.2f}ms  max={its.max()*1e3:6.2f}ms")
    print("\npaper: DAM-P shows the flattest iteration times during the "
          "interference window (Fig. 9a).")


if __name__ == "__main__":
    main()
