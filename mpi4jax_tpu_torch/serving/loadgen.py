"""Seeded open-loop load generator (docs/serving.md "load generator").

The port's copy of ``mpi4jax_tpu/serving/loadgen.py``.

Open-loop Poisson arrivals: inter-arrival gaps are exponential at the
configured rate and DO NOT wait for the system — a saturated server
keeps receiving (and must shed), which is exactly the regime admission
control exists for (closed-loop generators self-throttle and hide the
p99 blowup; benchmarks/serving.py explains the choice).

Deterministic: everything (gaps, prompt lengths, output lengths,
prompt token ids) derives from one ``random.Random(seed)``, so every
rank, every re-run, and the offline ``reference_greedy_decode`` oracle
see the identical workload.  Pure stdlib — no torch, no numpy.
"""

import random

from .request import Request

__all__ = ["LoadGen", "make_dist"]


def make_dist(spec):
    """A length distribution from a spec tuple:

    * ``("fixed", n)``           — always ``n``
    * ``("uniform", lo, hi)``    — integer uniform, inclusive
    * ``("bimodal", lo, hi, p)`` — ``lo`` with probability ``p`` else
      ``hi`` (the short-query/long-tail traffic shape)

    Returns ``f(rng) -> int``.  Raises ``ValueError`` on a malformed
    spec — a typo'd distribution must fail at setup, not quietly
    benchmark a different workload."""
    if not isinstance(spec, (tuple, list)) or not spec:
        raise ValueError(f"distribution spec must be a tuple, got {spec!r}")
    kind, *args = spec
    if kind == "fixed":
        (n,) = args
        if n < 1:
            raise ValueError(f"fixed length must be >= 1, got {n}")
        return lambda rng: int(n)
    if kind == "uniform":
        lo, hi = args
        if not 1 <= lo <= hi:
            raise ValueError(
                f"uniform bounds must satisfy 1 <= lo <= hi, got "
                f"({lo}, {hi})"
            )
        return lambda rng: rng.randint(int(lo), int(hi))
    if kind == "bimodal":
        lo, hi, p = args
        if not 1 <= lo <= hi:
            raise ValueError(
                f"bimodal bounds must satisfy 1 <= lo <= hi, got "
                f"({lo}, {hi})"
            )
        if not 0 <= p <= 1:
            raise ValueError(f"bimodal p must be in [0, 1], got {p}")
        return lambda rng: int(lo) if rng.random() < p else int(hi)
    raise ValueError(
        f"unknown distribution kind {kind!r} "
        "(want fixed|uniform|bimodal)"
    )


class LoadGen:
    """Generate a request stream.

    ``rate_rps`` is the open-loop arrival rate; ``prompt_len`` /
    ``max_new`` are distribution specs (:func:`make_dist`); prompt
    token ids are uniform over ``[0, vocab)``.  ``deadline_fn`` maps
    an arrival time to an absolute deadline (or ``None``) — the
    admission controller's ``deadline_for`` plugs in here.
    """

    def __init__(self, seed, rate_rps, prompt_len=("uniform", 4, 16),
                 max_new=("uniform", 4, 16), vocab=64,
                 deadline_fn=None, start_ms=0.0):
        if rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
        if vocab < 2:
            raise ValueError(f"vocab must be >= 2, got {vocab}")
        self.rng = random.Random(seed)
        self.rate_rps = float(rate_rps)
        self._prompt_len = make_dist(prompt_len)
        self._max_new = make_dist(max_new)
        self.vocab = int(vocab)
        self.deadline_fn = deadline_fn
        self._t_ms = float(start_ms)
        self._next_rid = 0
        self._pending_gap = None

    def _gap_ms(self):
        # a gap drawn-but-not-consumed by until() is served first, so
        # interleaved until/take calls see one continuous stream
        if self._pending_gap is not None:
            gap, self._pending_gap = self._pending_gap, None
            return gap
        return self.rng.expovariate(self.rate_rps) * 1e3

    def _emit(self):
        p_len = self._prompt_len(self.rng)
        prompt = tuple(
            self.rng.randrange(self.vocab) for _ in range(p_len)
        )
        req = Request(
            rid=self._next_rid,
            prompt=prompt,
            max_new=self._max_new(self.rng),
            arrival_ms=self._t_ms,
            deadline_ms=(self.deadline_fn(self._t_ms)
                         if self.deadline_fn else None),
        )
        self._next_rid += 1
        return req

    def next_request(self):
        """The next arrival (advances the clock by one Poisson gap)."""
        self._t_ms += self._gap_ms()
        return self._emit()

    def take(self, n):
        """The next ``n`` arrivals as a list."""
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        return [self.next_request() for _ in range(n)]

    def until(self, t_ms):
        """Every arrival up to absolute time ``t_ms`` (may be empty).

        Peeks one gap ahead without consuming it, so interleaved
        ``until`` calls see exactly the same stream as one big
        ``take``."""
        out = []
        while True:
            gap = self._gap_ms()
            if self._t_ms + gap > t_ms:
                # push the gap back: the NEXT call starts from here.
                # (random streams cannot be unread; keep the drawn gap
                # as a pending offset instead)
                self._pending_gap = gap
                return out
            self._t_ms += gap
            out.append(self._emit())
