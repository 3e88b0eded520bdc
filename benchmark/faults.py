"""Faults planted in the timed path, underneath the harness, to show that
the comparison catches them: `plant(name, model)` breaks one method of the
program instance, and the rest of the run is the real one. The tests run
each on the tiny cells (`correct` has to come out false) and
`benchmark/calibrate.py --fault` reads each on the card at a cell's own
size.

  alter_tokens   a token altered where it is produced: each batch's or
                 decode chunk's first token moved to the next id
  stale_state    a step that returns its state unchanged: every decode
                 step emits the token it started from again
  half_batch     half of the batch left out: the second half of each
                 batch or session's slots gets the first half's answers
  region_zero    the region path dropped: the region features (HFRE after
                 the aux projector) are zeros
  region_roll    the region path misaligned: each prompt's region
                 features moved one box along

Which apply to a cell follows from its driver: `for_driver(driver)`.
"""

from __future__ import annotations

import torch


def _finish_tokens(model, edit):
    finish = model.finish_batch

    def broken(handle):
        out = finish(handle)
        return edit(out)

    model.finish_batch = broken


def _chunk_tokens(model, edit):
    chunk = model.decode_session_chunk

    def broken(sess):
        toks, prev, steps = chunk(sess)
        return edit(sess, toks), prev, steps

    model.decode_session_chunk = broken


def alter_tokens(model):
    vocab = model.cfg.text.vocab_size

    def edit(out):
        for res in out:
            if len(res.token_ids):
                res.token_ids = res.token_ids.copy()
                res.token_ids[0] = (res.token_ids[0] + 1) % vocab
        return out

    def edit_chunk(sess, toks):
        toks = toks.clone()
        toks[:, 0] = (toks[:, 0] + 1) % vocab
        return toks

    _finish_tokens(model, edit)
    _chunk_tokens(model, edit_chunk)


def stale_state(model):
    def edit(out):
        for res in out:
            if len(res.token_ids):
                res.token_ids = res.token_ids[:1].repeat(len(res.token_ids))
        return out

    def edit_chunk(sess, toks):
        return sess["cur"][:, None].expand_as(toks).clone()

    _finish_tokens(model, edit)
    _chunk_tokens(model, edit_chunk)


def half_batch(model):
    def edit(out):
        half = max(1, len(out) // 2)
        return out[:half] + [out[i % half] for i in range(half, len(out))]

    def edit_chunk(sess, toks):
        half = max(1, toks.shape[0] // 2)
        idx = torch.arange(toks.shape[0], device=toks.device) % half
        return toks[idx]

    _finish_tokens(model, edit)
    _chunk_tokens(model, edit_chunk)


def _region(model, edit):
    proj = model.mm_projector_aux
    forward = proj.forward

    def broken(x):
        return edit(forward(x))

    proj.forward = broken


def region_zero(model):
    _region(model, torch.zeros_like)


def region_roll(model):
    _region(model, lambda r: torch.roll(r, 1, dims=-2))


FAULTS = {f.__name__: f for f in (alter_tokens, stale_state, half_batch,
                                  region_zero, region_roll)}


def for_driver(driver: str) -> list[str]:
    """The faults a cell of this driver can have (one request at a time
    has no second half)."""
    return [n for n in FAULTS if not (driver == "single"
                                      and n == "half_batch")]


def plant(name: str, model) -> None:
    FAULTS[name](model)
