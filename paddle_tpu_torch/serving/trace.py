"""Serving request records + the seeded Poisson arrival generator (the
port's own copy of ``paddle_tpu/serving/trace.py``, the wire codec
included: what it computes is unchanged, so both packages serve
byte-identical traces from one seed).

A Request is one user call: a prompt, a budget, per-request sampling
params (temperature / top-k / top-p / seed — seed None means greedy)
and an optional eos_id.  Arrival times are in ENGINE-STEP units (the
scheduler's virtual clock): a request becomes admittable at the first
step whose index >= arrival.  make_poisson_trace draws a reproducible
open-loop trace — exponential inter-arrivals at `rate` requests/step
over mixed prompt/output lengths — the bench/test workload shape;
make_prefix_trace the prefix-cache workload (shared templates and
fresh tails).
"""

import numpy as np

__all__ = ["Request", "make_poisson_trace", "make_prefix_trace"]


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

    # ---- wire codec (out-of-process pools) ----------------------------
    def to_wire(self):
        """Flatten to the RPC wire's closed type system (ints / floats /
        None / ndarray): from_wire must rebuild a Request whose schedule
        AND sampling keys are identical, or a stream replayed across the
        boundary leaves its solo run."""
        return {
            "rid": self.rid,
            "prompt": self.prompt,
            "max_new_tokens": self.max_new_tokens,
            "temperature": self.temperature,
            "top_k": self.top_k,
            "top_p": self.top_p,
            "seed": self.seed,
            "eos_id": self.eos_id,
            "arrival": self.arrival,
            "deadline": self.deadline,
            "sample_step_base": self.sample_step_base,
        }

    @classmethod
    def from_wire(cls, d):
        return cls(**d)

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


def make_prefix_trace(n_requests, rate, n_prefixes, prefix_len,
                      tail_len_range, out_len_range, vocab_size, seed=0,
                      reuse_fraction=0.8, sampled_fraction=0.5,
                      eos_id=None):
    """The prefix-heavy open-loop trace: a pool of `n_prefixes` shared
    template prefixes (system prompts / few-shot scaffolds) of
    `prefix_len` tokens each; every request with probability `reuse_fraction` opens with one of
    them (uniform choice) followed by a fresh random tail of
    tail_len_range tokens, else carries a fully random prompt of
    prefix_len//2 + tail tokens (cold traffic).  Arrivals, lengths and
    sampling params draw exactly like make_poisson_trace — seeded and
    deterministic, same seed -> byte-identical trace.

    Returns (requests, prefixes): register `prefixes` on the engine
    (engine.register_prefix) to arm the prefix cache; the same trace
    served with and without registration gives the same streams bit
    for bit, and only the prefill dispatch count and tokens/s move."""
    rng = np.random.RandomState(seed)
    prefix_len = int(prefix_len)
    prefixes = [rng.randint(1, vocab_size, prefix_len).astype("int64")
                for _ in range(int(n_prefixes))]
    t_lo, t_hi = tail_len_range
    o_lo, o_hi = out_len_range
    t = 0.0
    reqs = []
    for i in range(int(n_requests)):
        t += rng.exponential(1.0 / float(rate))
        tail = rng.randint(
            1, vocab_size, int(rng.randint(t_lo, t_hi + 1))).astype("int64")
        if rng.rand() < reuse_fraction:
            tmpl = prefixes[int(rng.randint(0, len(prefixes)))]
            prompt = np.concatenate([tmpl, tail])
        else:
            cold = rng.randint(
                1, vocab_size, max(1, prefix_len // 2)).astype("int64")
            prompt = np.concatenate([cold, tail])
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
    return reqs, prefixes
