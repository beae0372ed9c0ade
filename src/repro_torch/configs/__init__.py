"""Architecture registry: the 10 assigned LM-family configs plus the
paper's own four CNNs (VGG16 / AlexNet / ZF / YOLO).

Each LM config is importable as ``repro.configs.get(name)``; CNNs live in
``repro_torch.core.workload.CNN_MODELS`` and are selected through the same
``--arch`` flag by the launchers.
"""

from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.qwen2_72b import CONFIG as qwen2_72b
from repro_torch.configs.yi_6b import CONFIG as yi_6b
from repro_torch.configs.qwen3_1p7b import CONFIG as qwen3_1p7b
from repro_torch.configs.granite_34b import CONFIG as granite_34b
from repro_torch.configs.deepseek_v3_671b import CONFIG as deepseek_v3_671b
from repro_torch.configs.deepseek_v2_236b import CONFIG as deepseek_v2_236b
from repro_torch.configs.seamless_m4t_medium import CONFIG as seamless_m4t_medium
from repro_torch.configs.recurrentgemma_2b import CONFIG as recurrentgemma_2b
from repro_torch.configs.qwen2_vl_2b import CONFIG as qwen2_vl_2b
from repro_torch.configs.rwkv6_7b import CONFIG as rwkv6_7b

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (
        qwen2_72b, yi_6b, qwen3_1p7b, granite_34b, deepseek_v3_671b,
        deepseek_v2_236b, seamless_m4t_medium, recurrentgemma_2b,
        qwen2_vl_2b, rwkv6_7b,
    )
}

CNN_ARCHS = ("vgg16", "alexnet", "zf", "yolo")


def get(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; LM archs: {sorted(ARCHS)}; "
            f"CNNs (paper substrate): {CNN_ARCHS}") from None


__all__ = ["ModelConfig", "reduced", "ARCHS", "CNN_ARCHS", "get"]
