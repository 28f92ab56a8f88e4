"""The model substrate the serving path runs: dense and MoE decoder trunks
with GQA or MLA attention, Mamba2's SSD trunk, RecurrentGemma's hybrid
RG-LRU / local-attention trunk, the VLM's gated cross-attention groups and
the enc-dec's encoder and cross-attending decoder; prefill and decode."""
from repro_torch.models.transformer import Runtime  # noqa: F401
from repro_torch.models import model, decode  # noqa: F401
