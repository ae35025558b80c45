"""Multi-host launcher — replaces the reference's Spark orchestration.

The reference submits ``main_spark.py`` to a Spark cluster;
TensorFlowOnSpark reserves executors, assigns ps/worker/chief roles, and
exchanges the cluster spec (SURVEY.md §2.4). None of that machinery is
needed here: run ONE copy of this script per host with the same flags
plus per-host ``--process_id``; ``jax.distributed`` forms the process
group over the coordinator, ``jax.devices()`` becomes the global device
list, and the ('data','model') mesh spans every device. The synchronous
SPMD step replaces the async parameter-server loop.

One process drives all the devices of its host. On a host with four
GPUs that is one process for the four cards, never one per card: a JAX
process reserves most of each card's memory when it first uses it, so a
second process on the same cards fails for want of memory. A single
host needs no launcher at all (``cli/train.py`` with the mesh flags).

    # host 0 (also the coordinator)
    python -m openkeonspark_tpu.cli.launch --coordinator 10.0.0.1:1234 \
        --num_processes 2 --process_id 0 --mesh_data -1 --mesh_model 2 \
        --input gs://.../dataset --output ./out --model transe ...
    # host 1
    python -m openkeonspark_tpu.cli.launch ... --process_id 1 ...

``--mesh_data -1`` means "all remaining devices" after ``--mesh_model``.

Fault model (SURVEY.md §5 "Failure detection"): JAX multi-host jobs are
gang-scheduled — if a host dies the job restarts on all hosts and resumes
from the latest checkpoint in ``--output`` (the reference behaved the
same way via Spark re-launch + MonitoredTrainingSession restore)."""

from __future__ import annotations

import sys

import jax

from openkeonspark_tpu.cli.args import build_parser, config_from_args


def main(argv=None):
    from openkeonspark_tpu.runtime import enable_compile_cache
    enable_compile_cache()
    args = build_parser(__doc__).parse_args(argv)
    cfg = config_from_args(args)

    if cfg.coordinator:
        jax.distributed.initialize(coordinator_address=cfg.coordinator,
                                   num_processes=cfg.num_processes,
                                   process_id=cfg.process_id)
    n_dev = len(jax.devices())
    d, m = cfg.mesh_shape
    if d == -1:
        d = max(1, n_dev // max(m, 1))
    cfg = cfg.replace(mesh_shape=(d, m), coordinator="")

    if cfg.process_id == 0:
        print(f"{cfg.num_processes} process(es), {n_dev} device(s), "
              f"mesh=({d},{m})")

    from openkeonspark_tpu.cli.train import run
    echo = print if jax.process_index() == 0 else (lambda *_: None)
    run(cfg, echo=echo)


if __name__ == "__main__":
    main(sys.argv[1:])
