"""Model zoo of the LM substrate, the counterpart of ``repro/models``: the
generic decoder LM (attn / local_attn / rglru / mlstm / slstm blocks, dense
or MoE FFN), the enc-dec and the VLM, as ``nn.Module``s."""
from .encdec import EncDecLM  # noqa: F401
from .leaves import ParamLeaf, lm_param_leaves  # noqa: F401
from .transformer import DecoderLM  # noqa: F401
from .vlm import VLM  # noqa: F401
from .zoo import build_model  # noqa: F401
