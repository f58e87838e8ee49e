"""Architecture configs of the LM zoo (a copy of ``repro.configs``).

``get_config(name)`` returns the exact published configuration;
``get_config(name).reduced()`` returns the CPU-smoke-test scale-down of the
same family (same block pattern, tiny dims).
"""
from repro_torch.configs.base import (ArchConfig, MoECfg, MLACfg, SSMCfg,
                                      XLSTMCfg, ShapeSpec, SHAPES,
                                      shape_applicable)

_ARCH_MODULES = [
    "seamless_m4t_medium", "internvl2_1b", "deepseek_v2_236b", "arctic_480b",
    "xlstm_125m", "gemma_2b", "h2o_danube_3_4b", "starcoder2_7b", "qwen2_7b",
    "zamba2_2_7b",
]


def list_archs() -> list:
    return [m.replace("_", "-").replace("zamba2-2-7b", "zamba2-2.7b")
            .replace("h2o-danube-3-4b", "h2o-danube-3-4b") for m in _ARCH_MODULES]


def get_config(name: str) -> ArchConfig:
    mod_name = name.replace("-", "_").replace(".", "_")
    import importlib
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.config()


__all__ = ["ArchConfig", "MoECfg", "MLACfg", "SSMCfg", "XLSTMCfg",
           "ShapeSpec", "SHAPES", "shape_applicable", "get_config", "list_archs"]
