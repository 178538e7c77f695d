"""Serving request records + the seeded Poisson arrival generator (the
port's own copy of ``paddle_tpu/serving/trace.py``, without the
out-of-process wire codec: what it computes is unchanged, so both
packages serve byte-identical traces from one seed).

A Request is one user call: a prompt, a budget, per-request sampling
params (temperature / top-k / top-p / seed — seed None means greedy)
and an optional eos_id.  Arrival times are in ENGINE-STEP units (the
scheduler's virtual clock): a request becomes admittable at the first
step whose index >= arrival.  make_poisson_trace draws a reproducible
open-loop trace — exponential inter-arrivals at `rate` requests/step
over mixed prompt/output lengths — the bench/test workload shape.
"""

import numpy as np

__all__ = ["Request", "make_poisson_trace"]


class Request:
    """One serving request.  seed=None -> greedy decode; otherwise the
    token at request-step t draws from RandomState(fold_in_seed(seed,
    t)) — a pure function of (request, step), so the sample stream is
    identical solo or pooled (decode_cache.sample_rows_keyed)."""

    def __init__(self, rid, prompt, max_new_tokens, temperature=1.0,
                 top_k=0, top_p=1.0, seed=None, eos_id=None, arrival=0.0,
                 deadline=None, sample_step_base=0):
        self.rid = rid
        self.prompt = np.asarray(prompt, "int64").reshape(-1)
        assert self.prompt.size >= 1, (
            "empty prompt: seed generation with at least a BOS token")
        self.max_new_tokens = int(max_new_tokens)
        assert self.max_new_tokens >= 1, self.max_new_tokens
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = None if seed is None else int(seed)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.arrival = float(arrival)
        # admission control: engine steps from arrival within which the
        # request must FINISH — expiry while queued or mid-decode evicts
        # it with a terminal DEADLINE_EXPIRED status (None = no budget)
        self.deadline = None if deadline is None else int(deadline)
        assert self.deadline is None or self.deadline >= 1, deadline
        # failover replay (serving/router.py): a re-placed request's
        # prompt already CONTAINS the tokens the dead pool emitted, so
        # its sampling keys must start at the global token index, not 0
        # — fold_in(seed, base + request_step) keeps the re-decoded
        # stream on the solo run's sample sequence
        self.sample_step_base = int(sample_step_base)
        assert self.sample_step_base >= 0, sample_step_base

    @property
    def greedy(self):
        return self.seed is None

    @property
    def arrival_step(self):
        """First engine step at which this request is admittable."""
        import math

        return int(math.ceil(self.arrival))

    def __repr__(self):
        return ("Request(rid=%r, P=%d, new=%d, %s, arrival=%.2f)"
                % (self.rid, self.prompt.size, self.max_new_tokens,
                   "greedy" if self.greedy else "seed=%d" % self.seed,
                   self.arrival))


def make_poisson_trace(n_requests, rate, prompt_len_range, out_len_range,
                       vocab_size, seed=0, sampled_fraction=0.5,
                       eos_id=None):
    """Seeded open-loop trace: `n_requests` requests with exponential
    inter-arrival times at `rate` requests per engine step, prompt and
    output lengths uniform over the given (lo, hi) inclusive ranges,
    and a `sampled_fraction` of requests carrying heterogeneous
    per-request sampling params (the rest greedy).  Same seed -> the
    byte-identical trace, which is what makes the serve bench and the
    churn-exactness tests replayable."""
    rng = np.random.RandomState(seed)
    p_lo, p_hi = prompt_len_range
    o_lo, o_hi = out_len_range
    t = 0.0
    reqs = []
    for i in range(int(n_requests)):
        t += rng.exponential(1.0 / float(rate))
        p = int(rng.randint(p_lo, p_hi + 1))
        prompt = rng.randint(1, vocab_size, p).astype("int64")
        sampled = rng.rand() < sampled_fraction
        reqs.append(Request(
            rid=i,
            prompt=prompt,
            max_new_tokens=int(rng.randint(o_lo, o_hi + 1)),
            temperature=float(rng.uniform(0.7, 1.3)) if sampled else 1.0,
            top_k=int(rng.choice([0, 8, 32])) if sampled else 0,
            top_p=float(rng.choice([1.0, 0.9])) if sampled else 1.0,
            seed=int(rng.randint(0, 2 ** 31)) if sampled else None,
            eos_id=eos_id,
            arrival=t,
        ))
    return reqs
