"""The model substrate the serving path runs: dense and MoE decoder trunks
with GQA or MLA attention, prefill and per-slot decode (the other families
of the reference's ``models/`` — SSM, hybrid, VLM, enc-dec — are ROADMAP
queue A item 4's remaining work)."""
from repro_torch.models.transformer import Runtime  # noqa: F401
from repro_torch.models import model, decode  # noqa: F401
