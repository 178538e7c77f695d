"""High-level beam-search decoder (the counterpart of
``paddle_tpu/contrib/decoder/beam_search_decoder.py``, copied unchanged:
it is plain numpy, and keeping it identical is what lets a beam search
pick the same beams through either package from the same logits).

The decode loop is a host-driven step loop over one step program, with
the backtrack on the host.  States are plain padded arrays [batch,
beam, ...].
"""

import numpy as np


def _beam_topk(total, beam):
    """Shared beam-step selection: flatten [B, beam, V] candidate scores,
    take the top `beam` per example, split back into (parent beam, token,
    score) — the one top-k core behind both decoders."""
    b, _, vocab = total.shape
    flat = total.reshape(b, -1)
    # argpartition: O(beam*V) select, then sort only the `beam` survivors
    # (a full argsort of beam*vocab candidates per token is the hot-path
    # host cost for large vocabs)
    part = np.argpartition(-flat, beam - 1, axis=1)[:, :beam]
    part_scores = np.take_along_axis(flat, part, axis=1)
    order = np.argsort(-part_scores, axis=1)
    top_idx = np.take_along_axis(part, order, axis=1)
    top_scores = np.take_along_axis(part_scores, order, axis=1)
    parent = (top_idx // vocab).astype(np.int32)
    token = (top_idx % vocab).astype(np.int32)
    return parent, token, top_scores


class BeamSearchDecoder:
    """Drives a user step function through beam search.

    step_fn(token_ids [batch*beam], states) -> (log_probs [batch*beam, vocab],
    new_states) — typically a compiled Executor.run over a step program.
    """

    def __init__(self, step_fn, beam_size, start_token, end_token, max_len=32):
        self.step_fn = step_fn
        self.beam_size = beam_size
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.max_len = int(max_len)

    def decode(self, batch_size, init_states=None):
        """Returns (sentence_ids [batch, beam, <=max_len], scores [batch, beam])."""
        beam = self.beam_size
        pre_ids = np.full((batch_size, beam), self.start_token, np.int32)
        pre_scores = np.full((batch_size, beam), -1e9, np.float32)
        pre_scores[:, 0] = 0.0  # only beam 0 is live initially
        states = init_states

        ids_steps, parent_steps, score_steps = [], [], []
        for _ in range(self.max_len):
            logp, states = self.step_fn(pre_ids.reshape(-1), states)
            logp = np.asarray(logp, np.float32).reshape(batch_size, beam, -1)
            vocab = logp.shape[-1]

            finished = pre_ids == self.end_token
            cont = pre_scores[:, :, None] + logp
            frozen = np.full_like(cont, -1e9)
            frozen[:, :, self.end_token] = pre_scores
            total = np.where(finished[:, :, None], frozen, cont)

            parent, token, top_scores = _beam_topk(total, beam)

            ids_steps.append(token)
            parent_steps.append(parent)
            score_steps.append(top_scores)
            pre_ids, pre_scores = token, top_scores
            # states follow their beam's parent
            if states is not None:
                states = _reindex_states(states, parent, batch_size, beam)
            if (token == self.end_token).all():
                break

        # backtrack
        T = len(ids_steps)
        out = np.zeros((batch_size, beam, T), np.int32)
        ptr = np.tile(np.arange(beam, dtype=np.int32), (batch_size, 1))
        rows = np.arange(batch_size)[:, None]
        for t in range(T - 1, -1, -1):
            out[:, :, t] = ids_steps[t][rows, ptr]
            ptr = parent_steps[t][rows, ptr]
        return out, score_steps[-1]


def _reindex_states(states, parent, batch_size, beam):
    """Gather each state along the beam dim by parent index."""
    rows = np.arange(batch_size)[:, None]

    def gather(s):
        s = np.asarray(s)
        shaped = s.reshape(batch_size, beam, *s.shape[1:])
        return shaped[rows, parent].reshape(s.shape)

    if isinstance(states, dict):
        return {k: gather(v) for k, v in states.items()}
    if isinstance(states, (list, tuple)):
        return type(states)(gather(v) for v in states)
    return gather(states)


def full_sequence_beam_search(logits_fn, prompt_buf, prompt_len, beam_size,
                              max_out_len, eos_id, pad_id=0,
                              length_penalty=0.0):
    """Beam search over a fixed-shape full-sequence logits program.

    logits_fn(buf [R, T], cur) -> [R, vocab] next-token logits at position
    cur-1 for every row (R = batch*beam; typically one Executor.run of a
    gpt2_logits_program / transformer_logits_program).  prompt_buf [B, T]
    holds the prompts left-aligned (padded with pad_id); decoding starts
    at prompt_len.  Returns (ids [B, T_out], scores [B]) for the best beam
    per example; finished beams (emitted eos_id) carry their score
    unchanged, optionally normalized by length**length_penalty.
    """
    prompt_buf = np.asarray(prompt_buf)
    b, t = prompt_buf.shape
    limit = min(max_out_len, t)
    buf = np.repeat(prompt_buf, beam_size, axis=0)  # [B*beam, T]
    scores = np.full((b, beam_size), -1e9, np.float32)
    scores[:, 0] = 0.0
    finished = np.zeros((b, beam_size), bool)
    lengths = np.full((b, beam_size), prompt_len, np.int64)
    cur = prompt_len
    while cur < limit and not finished.all():
        logits = np.asarray(logits_fn(buf, cur), np.float32)
        (rows, step_tok, scores, lengths, finished) = _beam_step(
            logits, scores, finished, lengths, beam_size, eos_id, pad_id)
        buf = buf[rows]
        buf[:, cur] = step_tok
        cur += 1
    if length_penalty:
        scores = scores / (lengths.astype(np.float32) ** length_penalty)
    best = np.argmax(scores, axis=1)
    rows = np.arange(b) * beam_size + best
    return buf[rows][:, :cur], scores[np.arange(b), best]


def _logsumexp(x):
    m = x.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True))


def _beam_step(logits, scores, finished, lengths, beam_size, eos_id, pad_id):
    """One beam expansion shared by the full-sequence and incremental
    searches: finished beams emit pad at zero cost (score frozen), top-k
    over (scores + logp), parent gather.  Returns (flat parent rows,
    flat step tokens, scores, lengths, finished)."""
    b = scores.shape[0]
    logp = logits - _logsumexp(logits)
    v = logp.shape[-1]
    logp = logp.reshape(b, beam_size, v)
    fin = finished
    logp[fin] = -1e9
    logp[fin, pad_id] = 0.0
    cand = scores[:, :, None] + logp  # [B, beam, V]
    parent, tok, scores = _beam_topk(cand, beam_size)
    rows = (np.arange(b)[:, None] * beam_size + parent).reshape(-1)
    was_fin = np.take_along_axis(finished, parent, axis=1)
    step_tok = np.where(was_fin.reshape(-1), pad_id, tok.reshape(-1))
    lengths = np.take_along_axis(lengths, parent, axis=1) + (~was_fin)
    finished = was_fin | (tok == eos_id)
    return rows, step_tok, scores, lengths, finished


def incremental_beam_search(step_fn, reorder_fn, first_logits, prompt_buf,
                            prompt_len, beam_size, max_total_len, eos_id,
                            pad_id=0, length_penalty=0.0):
    """Beam search over a KV-CACHED one-token decode step.

    step_fn(tokens [R, 1], pos) -> [R, vocab] logits for the NEXT
    position; reorder_fn(rows [R]) shuffles the decoder's cache state to
    the selected parent rows BEFORE the next step (the reference's
    beam-search cache-shuffling contract); first_logits [R, vocab] are
    the logits after prefilling the prompt (R = batch*beam, prompt rows
    repeated per beam).  Scoring/finish semantics match
    full_sequence_beam_search; returns (ids [B, T_out], scores [B])."""
    prompt_buf = np.asarray(prompt_buf)
    b, p = prompt_buf.shape
    assert p == prompt_len
    limit = max_total_len
    buf = np.full((b * beam_size, limit), pad_id, np.int64)
    buf[:, :p] = np.repeat(prompt_buf, beam_size, axis=0)
    scores = np.full((b, beam_size), -1e9, np.float32)
    scores[:, 0] = 0.0
    finished = np.zeros((b, beam_size), bool)
    lengths = np.full((b, beam_size), prompt_len, np.int64)
    logits = np.asarray(first_logits, np.float32)
    cur = prompt_len
    while cur < limit and not finished.all():
        (rows, step_tok, scores, lengths, finished) = _beam_step(
            logits, scores, finished, lengths, beam_size, eos_id, pad_id)
        buf = buf[rows]
        buf[:, cur] = step_tok
        cur += 1
        if cur < limit and not finished.all():
            # caches follow the surviving beams — skipped on the final
            # pass, whose shuffle no further step would read
            reorder_fn(rows)
            logits = np.asarray(
                step_fn(step_tok[:, None].astype(np.int64), cur - 1),
                np.float32)
    if length_penalty:
        scores = scores / (lengths.astype(np.float32) ** length_penalty)
    best = np.argmax(scores, axis=1)
    rows = np.arange(b) * beam_size + best
    return buf[rows][:, :cur], scores[np.arange(b), best]
