"""Multirun sweeper: a cartesian product of CLI overrides, run as jobs.

    python -m framedipt_tpu_torch.tools.sweep --jobs 2 --devices 0,1 -- \
        python -m framedipt_tpu_torch.experiments.inference \
        inference.diffusion.num_t=2,5 inference.inpainting_samples.samples=1,3

Every ``key=v1,v2,...`` argument after ``--`` is a sweep axis; the
cartesian product of the axes is the job list. A value containing ``[``
passes through verbatim (a list-typed override). Each job runs as a
subprocess with:

- the axes' values substituted in place, one value each,
- ``FRAMEDIPT_JOB_NUM=<i>`` exported (the train and inference CLIs append
  ``_job<i>`` to their run names),
- round-robin device pinning over ``--devices`` through
  ``CUDA_VISIBLE_DEVICES``,
- at most ``--jobs`` subprocesses in flight.

The exit status is non-zero if any job fails; each job's output goes to
``--log_dir`` (default ``sweep_logs/``) as ``job_<i>.log``.
"""
from __future__ import annotations

import argparse
import itertools
import os
import pathlib
import subprocess
import sys
import time

from framedipt_tpu_torch.tools.log import get_logger

logger = get_logger()


def split_sweep_args(
    argv: list[str],
) -> tuple[list[str], list[tuple[int, str, list[str]]]]:
    """(template, axes): the command as given, and each sweep axis as
    (position, key, values)."""
    template: list[str] = []
    axes: list[tuple[int, str, list[str]]] = []
    for i, arg in enumerate(argv):
        if "=" in arg and "," in arg and "[" not in arg:
            key, _, raw = arg.partition("=")
            axes.append((i, key, raw.split(",")))
        template.append(arg)
    return template, axes


def expand_jobs(argv: list[str]) -> list[list[str]]:
    """Each job's argv: the cartesian product of the sweep axes, the last
    axis fastest."""
    template, axes = split_sweep_args(argv)
    if not axes:
        return [list(template)]
    jobs = []
    for combo in itertools.product(*[vals for _, _, vals in axes]):
        job = list(template)
        for (pos, key, _), val in zip(axes, combo):
            job[pos] = f"{key}={val}"
        jobs.append(job)
    return jobs


def run_sweep(
    base_cmd: list[str],
    jobs: int = 1,
    devices: list[str] | None = None,
    log_dir: pathlib.Path | str = "sweep_logs",
    dry_run: bool = False,
    extra_env: dict[str, str] | None = None,
) -> int:
    """Run the expanded job list; returns the number of failed jobs. A dry
    run prints the jobs and starts none."""
    job_cmds = expand_jobs(base_cmd)
    logger.info(f"sweep: {len(job_cmds)} jobs, {jobs} concurrent")
    if dry_run:
        for i, cmd in enumerate(job_cmds):
            print(f"[{i}] {' '.join(cmd)}")
        return 0

    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    running: list[tuple[int, subprocess.Popen]] = []
    failures = 0

    def collect_finished() -> None:
        nonlocal failures
        for idx, proc in [t for t in running if t[1].poll() is not None]:
            running.remove((idx, proc))
            if proc.returncode != 0:
                failures += 1
                logger.error(f"job {idx} failed (rc={proc.returncode}), "
                             f"see {log_dir}/job_{idx}.log")
            else:
                logger.info(f"job {idx} done")

    def wait_for_slot(limit: int) -> None:
        # Any finished job frees its slot, not only the oldest.
        while len(running) >= limit:
            collect_finished()
            if len(running) >= limit:
                time.sleep(0.2)

    for i, cmd in enumerate(job_cmds):
        wait_for_slot(max(1, jobs))
        env = dict(os.environ)
        env["FRAMEDIPT_JOB_NUM"] = str(i)
        if devices:
            env["CUDA_VISIBLE_DEVICES"] = devices[i % len(devices)]
        env.update(extra_env or {})
        # The child holds its own copy of the log's descriptor: close the
        # parent's at once, or a long sweep runs out of open files.
        with (log_dir / f"job_{i}.log").open("w") as log:
            running.append((i, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                                env=env)))
        logger.info(f"job {i}: {' '.join(cmd)}")
    wait_for_slot(1)
    return failures


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--jobs", type=int, default=1, help="most jobs running at once")
    ap.add_argument("--devices", default=None,
                    help="comma list of CUDA device ids for round-robin pinning")
    ap.add_argument("--log_dir", default="sweep_logs")
    ap.add_argument("--dry_run", action="store_true",
                    help="print the expanded job list and exit")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- followed by the base command with key=v1,v2 axes")
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no base command given (everything after --)")
    failures = run_sweep(
        cmd,
        jobs=args.jobs,
        devices=args.devices.split(",") if args.devices else None,
        log_dir=args.log_dir,
        dry_run=args.dry_run,
    )
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
