"""The model substrate the serving path runs: dense decoder trunks with GQA
attention, prefill and per-slot decode (the other families of the
reference's ``models/`` are ROADMAP queue A item 4's remaining work)."""
from repro_torch.models.transformer import Runtime  # noqa: F401
from repro_torch.models import model, decode  # noqa: F401
