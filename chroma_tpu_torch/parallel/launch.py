"""k ranks of a torch.distributed group from one call (the port's way of
getting k devices, as chroma_tpu.parallel.photon_mesh takes jax.devices()).

    results = run_ranks(fn, 2, args=(...,), backend='gloo')

starts two processes by spawn (fork is unusable once CUDA is initialised),
joins them in a group whose rendezvous is a file in a fresh temporary
directory (so concurrent callers never collide on a port), calls
fn(*args) in each and returns each rank's result, which must pickle, in
rank order. Every collective of the group and the whole call are bounded
by `timeout`: a rank that fails, dies or hangs makes run_ranks kill the
others and raise. Under torchrun none of this is needed:
parallel.photon_mesh() works in any initialised group.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_GRACE_S = 60.0  # time a rank has to exit once it has reported


def _default_backend(nranks):
    "NCCL with a card for every rank, else gloo."
    if torch.cuda.is_available() and nranks <= torch.cuda.device_count():
        return 'nccl'
    return 'gloo'


def _rank_main(fn, rank, nranks, init_method, backend, timeout, args,
               results):
    "One rank: join the group, run fn(*args), report (rank, ok, payload)."
    os.environ['LOCAL_RANK'] = str(rank)
    try:
        dist.init_process_group(
            backend, init_method=init_method, world_size=nranks, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        report = (rank, True, fn(*args))
        payload = pickle.dumps(report)
    except BaseException:  # reported to the parent, which raises
        payload = pickle.dumps((rank, False, traceback.format_exc()))
    results.put(payload)
    if dist.is_initialized():
        dist.destroy_process_group()


def _collect(procs, results, deadline, timeout):
    "Every rank's report, in rank order; raises on a failure or a timeout."
    got = {}
    while len(got) < len(procs):
        left = deadline - time.monotonic()
        if left <= 0:
            missing = sorted(set(range(len(procs))) - set(got))
            raise TimeoutError('ranks %s did not finish within %.0f s'
                               % (missing, timeout))
        try:
            rank, ok, payload = pickle.loads(
                results.get(timeout=min(left, 1.0)))
        except queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in got and p.exitcode is not None]
            if dead:
                try:  # a report written just before the exit
                    rank, ok, payload = pickle.loads(results.get(timeout=5))
                except queue.Empty:
                    raise RuntimeError('rank %d exited with code %s without '
                                       'a result' % (dead[0],
                                                     procs[dead[0]].exitcode))
            else:
                continue
        if not ok:
            raise RuntimeError('rank %d failed:\n%s' % (rank, payload))
        got[rank] = payload
    return [got[r] for r in range(len(procs))]


def run_ranks(fn, nranks, args=(), backend=None, timeout=600.0):
    """Run fn(*args) in `nranks` spawned processes joined in one
    torch.distributed group (`backend`: 'gloo', 'nccl', or the default:
    NCCL when every rank has a card of its own, else gloo); returns their
    results in rank order. `fn` must be importable by name (a module-level
    function) and its arguments and result must pickle. Each rank's
    LOCAL_RANK is its rank. Collectives time out after `timeout` seconds,
    and so does the whole call; a failing, dying or hanging rank raises
    here, after every rank has been stopped."""
    backend = backend or _default_backend(nranks)
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix='chroma_ranks_') as tmp:
        init = 'file://' + os.path.join(tmp, 'rendezvous')
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, rank, nranks, init, backend, timeout,
                                   tuple(args), results))
                 for rank in range(nranks)]
        for proc in procs:
            proc.start()
        finished, stuck = False, []
        try:
            out = _collect(procs, results, time.monotonic() + timeout,
                           timeout)
            finished = True
        finally:
            for proc in procs:
                proc.join(JOIN_GRACE_S if finished else 0)
            for proc in procs:
                if proc.is_alive():
                    stuck.append(proc.pid)
                    proc.kill()
                    proc.join(JOIN_GRACE_S)
    if stuck:
        raise RuntimeError('ranks with pids %s did not exit after reporting '
                           'and were killed' % stuck)
    return out
