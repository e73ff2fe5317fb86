"""Start the processes of one training run on this machine.

The JAX package's ``cli/launch.py`` (the reference's mpirun wrapper) for
the port: it spawns ``cli.train`` once per process with ``--coordinator``,
``--process-id`` and ``--num-processes``, and ``torch.distributed`` joins
them (``cli/train.py``: NCCL where every process has its own card, gloo
where processes share one or on ``--device cpu``):

    # two processes, the batch split over them (data ranks):
    python -m voxsrc2020_speaker_verification_tpu_torch.cli.launch \\
        --num-processes 2 -- \\
        --recipe res2net_vox2_dev_aug --data-root data

    # the sc_cm_linear head's classes split over two model ranks:
    python -m voxsrc2020_speaker_verification_tpu_torch.cli.launch \\
        --num-processes 2 -- \\
        --recipe res2net_vox2_dev_aug --data-root data --num-model-shards 2

    # the plain path on the CPU (gloo):
    python -m voxsrc2020_speaker_verification_tpu_torch.cli.launch \\
        --num-processes 2 -- --recipe res2net_vox2_dev_aug --synthetic \\
        --device cpu --batch-size 8 --feat-length 32 --max-steps 2

    # across machines: the same command on each, with --process-offset i *
    # (processes per machine), --local-processes, and --coordinator at
    # process 0's machine

Everything after ``--`` goes to ``cli.train``. Process 0's output streams
through; process i > 0 logs to ``launch_rank<i>.log`` in the working
directory. The exit code is the first non-zero code of a process, which is
reported on stderr.
"""

from __future__ import annotations

import argparse
import subprocess
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--num-processes", type=int, required=True,
                   help="total process count across all machines")
    p.add_argument("--local-processes", type=int, default=None,
                   help="processes to spawn here (default: all)")
    p.add_argument("--process-offset", type=int, default=0,
                   help="first process id on this machine")
    p.add_argument("--coordinator", default="localhost:12355",
                   help="host:port of process 0 (its TCP store)")
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--" in argv:
        split = argv.index("--")
        own, fwd = argv[:split], argv[split + 1:]
    else:
        own, fwd = argv, []
    args = build_parser().parse_args(own)

    local = args.local_processes or args.num_processes
    procs = []
    try:
        for i in range(local):
            pid = args.process_offset + i
            cmd = [sys.executable, "-m", "voxsrc2020_speaker_verification_tpu_torch.cli.train",
                   "--coordinator", args.coordinator, "--process-id", str(pid),
                   "--num-processes", str(args.num_processes), *fwd]
            if pid == 0:
                procs.append((pid, subprocess.Popen(cmd), None))
            else:
                log = open(f"launch_rank{pid}.log", "w")
                procs.append((pid, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                              log))
        rc = 0
        for pid, proc, log in procs:
            code = proc.wait()
            if log:
                log.close()
            if code != 0:
                print(f"rank {pid} exited with {code}", file=sys.stderr)
                rc = rc or code
        return rc
    finally:  # no process outlives the launcher
        for _, proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


if __name__ == "__main__":
    sys.exit(main())
