"""Distributed solve farm: ZMQ REQ/REP servers + optional Redis discovery.

Twin of ``pmpc_tpu/remote.py``, with its wire format and behavior (parity
with the reference farm, ``pmpc/remote.py``):

- payload = ``cloudpickle.dumps((sys.path, zstd(cloudpickle((method, args,
  kwargs)))))`` request, ``zstd(cloudpickle(result))`` reply
  (``remote.py:71-79,246-276``), so JAX-package and reference clients can
  talk to these workers and vice versa,
- a whitelist of callable methods (``SUPPORTED_METHODS``, ``remote.py:23-25``),
  ``solve_batch`` being the port's `batch.solve_problems`,
- worker registration in Redis under ``pmpc_worker_{host}_{pid}`` keys with a
  60 s TTL heartbeat (``remote.py:187-204``); Redis absent -> standalone mode,
- parent watchdog kills servers stale >60 s and resurrects them on the next
  port (``remote.py:497-513``),
- greedy client-side scheduler with per-job timeout and dead-worker requeue
  (``remote.py:391-452``),
- a warm-up solve on server start stands in for the reference's
  ``precompilation_call`` (``remote.py:133-166``).

What differs from the JAX farm: workers start with ``spawn`` (CUDA does not
survive a fork; the parent never touches the card), each serves on
``--device`` (the card when not given), which the ``solve``,
``solve_batch`` and ``tune_scp`` requests take unless they name one; a
result's tensors cross the wire as numpy arrays; and a failed warm-up (a
kernel that does not build) kills the worker where the JAX one swallows it.
A request's exception is still returned to the client.

Needs pyzmq, zstandard and cloudpickle (redis optional); importing this
module without them works, serving and calling do not.
"""

from __future__ import annotations

import os
import random
import sys
import time
from argparse import ArgumentParser
from multiprocessing import get_context
from socket import gethostbyname, gethostname
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

try:
    import zmq
    import zstandard
    import cloudpickle as serializer
except ImportError:  # pragma: no cover
    zmq = zstandard = serializer = None

try:
    import redis
except ModuleNotFoundError:
    redis = None

from .batch import solve_problems as batch_solve_problems
from .canonical import lqp_generate_problem_matrices
from .scp import solve as solve_, scp_solve
from .tune import tune_scp as tune_scp_

SUPPORTED_METHODS: Dict[str, Callable] = dict(
    solve=solve_,
    tune_scp=tune_scp_,
    lqp_generate_problem_matrices=lqp_generate_problem_matrices,
    # whole-batch solve in ONE request served by ONE worker (the stacked or
    # fused=True device program) — named solve_batch to avoid colliding with
    # remote.solve_problems, the multi-worker scheduler that fans out
    # per-problem requests
    solve_batch=batch_solve_problems,
)
# the methods that run on the worker's device unless the request names one
_DEVICE_METHODS = ("solve", "tune_scp", "solve_batch")

DEFAULT_PORT = 65535 - 7117
DEFAULT_HOSTNAME = "localhost"
HOSTNAME = gethostname()
PID = os.getpid()

REDIS_CONFIG: Dict[str, Any] = {}
if os.getenv("REDIS_HOST") is not None:
    REDIS_CONFIG["host"] = gethostbyname(os.getenv("REDIS_HOST"))
if os.getenv("REDIS_PORT") is not None:
    REDIS_CONFIG["port"] = int(os.getenv("REDIS_PORT"))
if os.getenv("REDIS_PASSWORD") is not None:
    REDIS_CONFIG["password"] = os.getenv("REDIS_PASSWORD")


def _to_host(obj):
    """A result with every tensor (a CUDA warm tuple, say) as a numpy array,
    through dicts, lists and tuples: what crosses the wire is host data."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # a NamedTuple
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _compress(obj) -> bytes:
    return zstandard.compress(serializer.dumps(obj))


def _decompress(buf: bytes):
    return serializer.loads(zstandard.decompress(buf))


_FN_REGISTRY: Dict[str, Callable] = {}


def register_fn(fn: Callable) -> "RegisteredFunction":
    """Wrap a callback so that repeat messages shipping the same function
    dispatch to the live object already known to the worker (role of the
    reference's function-hash cache, ``pmpc/remote.py:44-55``)."""
    return RegisteredFunction(fn)


class RegisteredFunction:
    """Callable wrapper keyed by the sha256 digest of its serialized payload.

    On the worker, the first call installs the deserialized function into the
    module-level registry under its digest; later wrappers with the same
    digest (e.g. the same user callback shipped in every SCP message) reuse
    that live object instead of paying deserialization again.
    """

    __slots__ = ("fn", "digest")

    def __init__(self, fn: Callable) -> None:
        import hashlib

        self.fn = fn
        self.digest = hashlib.sha256(serializer.dumps(fn)).hexdigest()

    def __call__(self, *args, **kwargs):
        live = _FN_REGISTRY.get(self.digest)
        if live is None:
            _FN_REGISTRY[self.digest] = live = self.fn
        return live(*args, **kwargs)


# -- client ------------------------------------------------------------------------


def call(
    method: str,
    hostname: Optional[str] = None,
    port: Optional[int] = None,
    blocking: bool = True,
    *args,
    **kwargs,
) -> Union[Any, Callable]:
    """Invoke a whitelisted method on a remote worker (blocking or poll-fn)."""
    hostname = hostname if hostname is not None else DEFAULT_HOSTNAME
    port = port if port is not None else DEFAULT_PORT
    msg = serializer.dumps((sys.path, _compress((method, args, kwargs))))
    ctx = zmq.Context()
    sock = ctx.socket(zmq.REQ)
    if blocking:
        try:
            sock.connect(f"tcp://{hostname}:{port}")
            sock.send(msg)
            return _decompress(sock.recv())
        finally:
            sock.close(0)
            ctx.term()
    sock.setsockopt(zmq.RCVTIMEO, 2000)
    sock.setsockopt(zmq.SNDTIMEO, 2000)
    sock.setsockopt(zmq.LINGER, 0)
    sock.connect(f"tcp://{hostname}:{port}")
    sock.send(msg)

    def poll_fn():
        if sock.poll(1e-4) == zmq.POLLIN:
            out = _decompress(sock.recv())
            poll_fn.close()  # fds/IO-threads released on arrival, not gc
            return out
        return "NOT_ARRIVED_YET"

    def close():
        try:
            sock.close(0)
        except Exception:
            pass
        try:
            ctx.term()
        except Exception:
            pass

    poll_fn.sock, poll_fn.ctx, poll_fn.close = sock, ctx, close
    return poll_fn


def solve(*args, **kw):
    return call("solve", solve.hostname, solve.port, solve.blocking, *args, **kw)


solve.hostname = DEFAULT_HOSTNAME
solve.port = DEFAULT_PORT
solve.blocking = True


def tune_scp(*args, **kw):
    return call("tune_scp", tune_scp.hostname, tune_scp.port, tune_scp.blocking, *args, **kw)


tune_scp.hostname = DEFAULT_HOSTNAME
tune_scp.port = DEFAULT_PORT
tune_scp.blocking = True


# -- redis discovery ---------------------------------------------------------------


def _redis_client():
    if redis is None:
        return None
    try:
        r = redis.Redis(**REDIS_CONFIG)
        r.ping()
        return r
    except Exception:
        return None


def register_worker(port: int, ttl: int = 60) -> None:
    r = _redis_client()
    if r is None:
        return
    try:
        ip = gethostbyname(HOSTNAME)
    except Exception:
        ip = "127.0.0.1"
    # key format must carry the address after "/" so reference clients — which
    # parse key.split("/")[1].split(":") (reference remote.py:383-385) — can
    # discover these workers; the value serves value-parsing clients (ours)
    key = f"pmpc_worker_{HOSTNAME}_{os.getpid()}/{HOSTNAME}:{port}"
    r.set(key, f"{ip}:{port}", ex=ttl)


def scan_workers() -> List[Tuple[str, int]]:
    r = _redis_client()
    if r is None:
        return []
    out = []
    for key in r.scan_iter("pmpc_worker_*"):
        try:
            val = r.get(key)
            host, port = val.decode().rsplit(":", 1)
            out.append((host, int(port)))
        except Exception:
            continue
    return out


# -- server ------------------------------------------------------------------------


def precompilation_call(device=None) -> None:
    """A tiny unbounded and bounded solve on ``device`` (the stand-in for
    remote.py:133-166): on the card it builds the kernel and pays the
    process's first CUDA calls. Raises when they fail."""
    N, xdim, udim = 5, 2, 1
    A = np.array([[1.0, 0.1], [0.0, 1.0]])
    B = np.array([[0.005], [0.1]])

    def f_fx_fu_fn(X, U):
        f = X @ A.T + U @ B.T
        fx = np.broadcast_to(A, X.shape[:-1] + A.shape)
        fu = np.broadcast_to(B, X.shape[:-1] + B.shape)
        return f, fx, fu

    Q = np.tile(np.eye(xdim), (N, 1, 1))
    R = np.tile(np.eye(udim), (N, 1, 1))
    for bounded in (False, True):
        kw = {}
        if bounded:
            kw = dict(u_l=-np.ones((N, udim)), u_u=np.ones((N, udim)))
        scp_solve(f_fx_fu_fn, Q, R, np.ones(xdim), max_it=2, verbose=False,
                  device=device, **kw)


def _server(port: int, status_flag, warmup: bool = True, device=None) -> None:
    import threading

    ctx = zmq.Context()
    sock = ctx.socket(zmq.REP)
    sock.bind(f"tcp://*:{port}")
    sock.setsockopt(zmq.RCVTIMEO, 2000)
    if warmup:
        # not swallowed: a kernel that fails to build ends the worker here,
        # where it shows, not in every request
        precompilation_call(device)

    def _beat():
        # liveness from a daemon thread: the main loop can be busy for
        # minutes inside a single solve (first-call compiles), during which
        # a loop-updated flag would go stale and the parent watchdog would
        # kill a perfectly healthy worker mid-solve
        while True:
            status_flag.value = time.time()
            register_worker(port)
            time.sleep(5.0)

    threading.Thread(target=_beat, daemon=True).start()
    while True:
        try:
            raw = sock.recv()
        except zmq.error.Again:
            continue
        try:
            syspath, payload = serializer.loads(raw)
            for p in syspath:
                if p not in sys.path:
                    sys.path.append(p)
            method, args, kwargs = _decompress(payload)
            if method not in SUPPORTED_METHODS:
                raise ValueError(f"method {method} not supported")
            if device is not None and method in _DEVICE_METHODS:
                kwargs.setdefault("device", device)
            result = _to_host(SUPPORTED_METHODS[method](*args, **kwargs))
        except Exception as e:  # report the exception to the client
            result = e
        try:
            out = _compress(result)
        except Exception as e:  # result not serializable: still reply
            out = _compress(RuntimeError(f"result serialization failed: {e!r}"))
        try:
            sock.send(out)
        except Exception:
            # a failed send leaves the REP state machine stuck (it must
            # alternate recv/send): rebuild the socket
            try:
                sock.close(0)
            except Exception:
                pass
            sock = ctx.socket(zmq.REP)
            sock.bind(f"tcp://*:{port}")
            sock.setsockopt(zmq.RCVTIMEO, 2000)


class Server:
    """A worker process wrapping `_server` with liveness tracking."""

    def __init__(self, port: int, warmup: bool = True, device=None):
        # spawn: a forked child cannot use CUDA, and the parent never touches it
        mp = get_context("spawn")
        self.port = port
        self.status_flag = mp.Value("d", time.time())
        self.process = mp.Process(target=_server,
                                  args=(port, self.status_flag, warmup, device))
        self.process.daemon = True

    def start(self):
        self.process.start()
        return self

    def is_alive(self, stale_after: float = 60.0) -> bool:
        return self.process.is_alive() and (time.time() - self.status_flag.value) < stale_after

    def kill(self):
        if self.process.is_alive():
            self.process.terminate()
            self.process.join(timeout=5.0)


def start_server(port: int = DEFAULT_PORT, warmup: bool = True, device=None) -> Server:
    return Server(port, warmup=warmup, device=device).start()


# -- batch scheduler ---------------------------------------------------------------


def rescan_workers(existing: Optional[List[Tuple[str, int]]] = None) -> List[Tuple[str, int]]:
    """Discovered workers MERGED with the caller's explicit list — an explicit
    list must never be silently replaced by (possibly stale) Redis entries,
    nor dropped on the all-broken requeue path."""
    workers = list(dict.fromkeys(list(existing or []) + scan_workers()))
    if not workers:
        workers = [(DEFAULT_HOSTNAME, DEFAULT_PORT)]
    return workers


def solve_problems(
    problems: List[Dict[str, Any]],
    workers: Optional[List[Tuple[str, int]]] = None,
    max_solve_time: float = 20.0,
    verbose: bool = False,
) -> List[Any]:
    """Greedy farm scheduler: assign problems to free workers, poll, requeue
    jobs from dead workers (parity with ``remote.py:391-452``)."""
    workers = rescan_workers(workers)
    n = len(problems)
    results: List[Any] = [None] * n
    pending = list(range(n))
    in_flight: Dict[Tuple[str, int], Tuple[int, Callable, float]] = {}
    broken: set = set()

    while pending or in_flight:
        free = [w for w in workers if w not in in_flight and w not in broken]
        while pending and free:
            w = random.choice(free)
            free.remove(w)
            idx = pending.pop(0)
            fn = call("solve", w[0], w[1], False, **problems[idx])
            in_flight[w] = (idx, fn, time.time())
        done_workers = []
        for w, (idx, fn, t0) in in_flight.items():
            ret = fn()
            arrived = not (isinstance(ret, str) and ret == "NOT_ARRIVED_YET")
            if arrived:
                results[idx] = ret
                done_workers.append(w)
            elif time.time() - t0 > max_solve_time:
                broken.add(w)
                pending.append(idx)
                done_workers.append(w)
                try:
                    fn.close()
                except Exception:
                    pass
        for w in done_workers:
            in_flight.pop(w)
        if not in_flight and pending and all(w in broken for w in workers):
            workers = rescan_workers(workers)
            broken.clear()
        time.sleep(1e-3)
    return results


# -- CLI ---------------------------------------------------------------------------


def main():  # pragma: no cover - exercised via subprocess in tests
    parser = ArgumentParser("pmpc_tpu_torch.remote", description="pmpc_tpu_torch solve farm")
    parser.add_argument("--port", type=int, default=DEFAULT_PORT)
    parser.add_argument("--worker-num", type=int, default=1)
    parser.add_argument("--resurrect", action="store_true")
    parser.add_argument("--no-warmup", action="store_true")
    parser.add_argument("--device", default=None,
                        help="the workers' device (default: the card; e.g. cpu, cuda:1)")
    args = parser.parse_args()
    start = lambda port: start_server(port, warmup=not args.no_warmup, device=args.device)

    # SIGTERM must run atexit so the daemon worker processes are reaped —
    # the default handler exits without cleanup and ORPHANS them (observed:
    # a day-old leaked worker answering a fresh test run's requests)
    import signal

    signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))

    servers = {}
    next_port = args.port
    for _ in range(args.worker_num):
        servers[next_port] = start(next_port)
        next_port += 1
    print(f"pmpc_tpu_torch farm: {args.worker_num} worker(s) on ports "
          f"{args.port}..{next_port - 1}", flush=True)
    try:
        while True:
            time.sleep(5.0)
            for port, srv in list(servers.items()):
                if not srv.is_alive():
                    srv.kill()
                    del servers[port]
                    if args.resurrect:
                        servers[next_port] = start(next_port)
                        next_port += 1
            if not servers:
                print("pmpc_tpu_torch farm: every worker died", file=sys.stderr, flush=True)
                sys.exit(1)
    except KeyboardInterrupt:
        for srv in servers.values():
            srv.kill()


if __name__ == "__main__":
    main()
