"""Faults planted under the harness, in the timed path: each wraps an entry
adapter's block function (run_cell's `block_hook`) so that the run it
drives is broken in one way a cell on one chip can be. The tests hold
`correct` false for each; benchmark/tools/faults.py reads them on the card.
"""

import dataclasses


def _replace(state, **fields):
    """The state with the given tensors swapped in (an MCState)."""
    keep = {k: v for k, v in fields.items() if hasattr(state, k)}
    return dataclasses.replace(state, **keep)


def unchanged(block):
    """A step that returns its state unchanged (after the warm block)."""
    seen = {}

    def broken(run, st):
        if not seen:
            st, seen["view"] = block(run, st)
        return st, seen["view"]
    return broken


def half_batch(block):
    """Half of the batch left out: the second half of the chains keeps the
    block's input."""
    prev = {}

    def broken(run, st):
        st, view = block(run, st)
        h = st.sigma.shape[0] // 2
        view = dict(view)
        if prev:
            for k, old in prev.items():
                t = view[k].clone()
                t[h:] = old[h:].to(t.dtype)
                view[k] = t
            st = _replace(st, sigma=view["sigma"],
                          E=view["E"].to(st.E.dtype),
                          accepted=view.get("accepted", st.accepted))
        prev.update({k: view[k].clone() for k in ("sigma", "E", "accepted")
                     if view.get(k) is not None})
        return st, view
    return broken


def altered(block):
    """An answer altered where it is produced: one spin of chain 0 flipped
    in the output, its energy left as it was."""
    def broken(run, st):
        st, view = block(run, st)
        sigma = view["sigma"].clone()
        sigma[0, 0] = -sigma[0, 0]
        return _replace(st, sigma=sigma), dict(view, sigma=sigma)
    return broken


def half_work(block):
    """Half the work: each block runs half the moves or iterations that
    the traffic asks for, and reports them as the whole."""
    def broken(run, st):
        t = dict(run.traffic, block=int(run.traffic["block"]) // 2)
        return block(dataclasses.replace(run, traffic=t), st)
    return broken


FAULTS = {f.__name__: f for f in (unchanged, half_batch, altered, half_work)}
