"""Model registry — name -> UNetSpec (counterpart of
eyoc_tpu/models/__init__.py; the same specs, copied). The published EYOC
model is ResUNetBN2C.
"""

from __future__ import annotations

from eyoc_tpu_torch.models.unet import ResUNet, UNetSpec, init_unet

__all__ = ["UNetSpec", "ResUNet", "init_unet", "load_model", "MODELS"]


def _res(name, ch, tr, block_norm="BN", repeats=1):
    return UNetSpec(
        name=name, norm_type="BN", block_norm_type=block_norm,
        channels=ch, tr_channels=tr, repeats=repeats,
        conv1_tr_kernel=1, conv1_tr_norm=False,
    )


def _simple(name, ch, tr, norm):
    return UNetSpec(
        name=name, norm_type=norm, block_norm_type=None,
        channels=ch, tr_channels=tr, repeats=1,
        conv1_tr_kernel=3, conv1_tr_norm=True,
    )


_CH2 = (32, 64, 128, 256)

MODELS = {
    # ---- ResUNet family (reference model/resunet.py:196-251)
    "ResUNetBN2": _res("ResUNetBN2", _CH2, (32, 64, 64, 128)),
    "ResUNetBN2B": _res("ResUNetBN2B", _CH2, (64, 64, 64, 64)),
    "ResUNetBN2C": _res("ResUNetBN2C", _CH2, (64, 64, 64, 128)),
    "ResUNetBN2D": _res("ResUNetBN2D", _CH2, (64, 64, 128, 128)),
    "ResUNetBN2E": _res("ResUNetBN2E", (128, 128, 128, 256), (64, 128, 128, 128)),
    "ResUNetFatBN": _res("ResUNetFatBN", _CH2, (128, 128, 128, 256)),
    # IN variants keep BN top-level norms but use IN inside blocks
    "ResUNetIN2": _res("ResUNetIN2", _CH2, (32, 64, 64, 128), block_norm="IN"),
    "ResUNetIN2B": _res("ResUNetIN2B", _CH2, (64, 64, 64, 64), block_norm="IN"),
    "ResUNetIN2C": _res("ResUNetIN2C", _CH2, (64, 64, 64, 128), block_norm="IN"),
    "ResUNetIN2D": _res("ResUNetIN2D", _CH2, (64, 64, 128, 128), block_norm="IN"),
    "ResUNetIN2E": _res("ResUNetIN2E", (128, 128, 128, 256), (64, 128, 128, 128), block_norm="IN"),
    # two (norm, block) repeats per level (reference model/resunet.py:406-492)
    "ResUNetExpBN2C": _res("ResUNetExpBN2C", _CH2, (64, 64, 64, 128), repeats=2),
    # ---- SimpleNet family (reference model/simpleunet.py)
    "SimpleNetBN": _simple("SimpleNetBN", (32, 64, 128), (32, 32, 64), "BN"),
    "SimpleNetIN": _simple("SimpleNetIN", (32, 64, 128), (32, 32, 64), "IN"),
    "SimpleNetBNE": _simple("SimpleNetBNE", (16, 32, 32), (16, 16, 32), "BN"),
    "SimpleNetINE": _simple("SimpleNetINE", (16, 32, 32), (16, 16, 32), "IN"),
    "SimpleNetBN2": _simple("SimpleNetBN2", _CH2, (32, 32, 64, 64), "BN"),
    "SimpleNetIN2": _simple("SimpleNetIN2", _CH2, (32, 32, 64, 64), "IN"),
    "SimpleNetBN2B": _simple("SimpleNetBN2B", _CH2, (64, 64, 64, 64), "BN"),
    "SimpleNetBN2C": _simple("SimpleNetBN2C", _CH2, (32, 64, 64, 128), "BN"),
    "SimpleNetBN2D": _simple("SimpleNetBN2D", _CH2, (32, 64, 64, 128), "BN"),
    "SimpleNetBN2E": _simple("SimpleNetBN2E", (16, 32, 64, 128), (16, 32, 32, 64), "BN"),
    "SimpleNetIN2E": _simple("SimpleNetIN2E", (16, 32, 64, 128), (16, 32, 32, 64), "IN"),
    "SimpleNetBN3": _simple("SimpleNetBN3", (32, 64, 128, 256, 512), (32, 32, 64, 64, 128), "BN"),
    "SimpleNetIN3": _simple("SimpleNetIN3", (32, 64, 128, 256, 512), (32, 32, 64, 64, 128), "IN"),
    "SimpleNetBN3B": _simple("SimpleNetBN3B", (32, 64, 128, 256, 512), (32, 64, 64, 64, 128), "BN"),
    "SimpleNetBN3C": _simple("SimpleNetBN3C", (32, 64, 128, 256, 512), (32, 32, 64, 128, 128), "BN"),
    "SimpleNetBN3D": _simple("SimpleNetBN3D", (32, 64, 128, 256, 512), (32, 64, 64, 128, 128), "BN"),
    "SimpleNetBN3E": _simple("SimpleNetBN3E", (16, 32, 64, 128, 256), (16, 32, 32, 64, 128), "BN"),
    "SimpleNetIN3E": _simple("SimpleNetIN3E", (16, 32, 64, 128, 256), (16, 32, 32, 64, 128), "IN"),
}


def load_model(name: str) -> UNetSpec:
    if name not in MODELS:
        raise ValueError(
            f"Unknown model {name!r}; available: {sorted(MODELS)}"
        )
    return MODELS[name]
