"""The model substrate the serving path runs: dense and MoE decoder trunks
with GQA or MLA attention, Mamba2's SSD trunk and RecurrentGemma's hybrid
RG-LRU / local-attention trunk, prefill and decode (the VLM and enc-dec
families of the reference's ``models/`` are ROADMAP queue A item 4's
remaining work)."""
from repro_torch.models.transformer import Runtime  # noqa: F401
from repro_torch.models import model, decode  # noqa: F401
