"""Faults planted in the timed path underneath a run, by monkeypatching
the port or the harness's hold on it (``mp``: pytest's ``monkeypatch``):
each is one a cell can have, and each has to turn ``correct`` false."""


def token_altered(mp):
    """Serving: every sampled token moved to the next id."""
    from repro_torch.serving import engine
    orig = engine._sample_tokens

    def altered(logits, *a, **kw):
        return (orig(logits, *a, **kw) + 1) % logits.shape[-1]
    mp.setattr(engine, "_sample_tokens", altered)


def decode_state_unchanged(mp):
    """Serving: a decode step that hands back its cache unchanged."""
    from repro_torch.models import decode
    orig = decode.decode_step

    def unchanged(cfg, rt, p, token, pos, state):
        copy = {"layers": {k: v.clone() for k, v in state["layers"].items()}}
        return orig(cfg, rt, p, token, pos, copy)[0], state
    mp.setattr(decode, "decode_step", unchanged)


def decode_half_batch(mp):
    """Serving: the second half of the slots given the first half's
    logits."""
    from repro_torch.models import decode
    orig = decode.decode_step

    def half(cfg, rt, p, token, pos, state):
        logits, state = orig(cfg, rt, p, token, pos, state)
        B = logits.shape[0]
        logits = logits.clone()
        logits[B // 2:] = logits[:B - B // 2]
        return logits, state
    mp.setattr(decode, "decode_step", half)


def _wrap_train_step(mp, wrap):
    from bench.core import program
    orig = program.train_step

    def patched(cfg, opt):
        step, make_state = orig(cfg, opt)
        return wrap(step), make_state
    mp.setattr(program, "train_step", patched)


def train_state_unchanged(mp):
    """Training: a step that returns its state unchanged."""
    def wrap(step):
        def unchanged(state, batch):
            return state, step(state, batch)[1]
        return unchanged
    _wrap_train_step(mp, wrap)


def train_half_batch(mp):
    """Training: every step on the first half of its batch's rows, the
    mean taken over those alone."""
    def wrap(step):
        def half(state, batch):
            tokens = batch["tokens"]
            return step(state, dict(batch,
                                    tokens=tokens[:tokens.shape[0] // 2]))
        return half
    _wrap_train_step(mp, wrap)


SERVE = {"token_altered": token_altered,
         "state_unchanged": decode_state_unchanged,
         "half_batch": decode_half_batch}
TRAIN = {"state_unchanged": train_state_unchanged,
         "half_batch": train_half_batch}
