"""Evaluate a SiamWCA checkpoint with the asymmetric previous-frame branch
turned off (counterpart of ``tools/eval_asym.py``): the evaluation CLI
(``tools/test.py``) with ``MODEL.BACKBONE_3D.ASYMMETRIC.ENABLED`` forced
false before the model is built.

    python -m tmae_tpu_torch.tools.eval_asym --cfg_file <cfg> --ckpt <file>

Takes every argument of ``python -m tmae_tpu_torch.tools.test``.
"""

from __future__ import annotations

from . import test


def main(argv=None):
    """Returns ``{result directory: AP dict}`` as ``tools.test.main``."""
    args, cfg = test.parse_config(argv)
    if 'ASYMMETRIC' in cfg.MODEL.BACKBONE_3D:
        cfg.MODEL.BACKBONE_3D.ASYMMETRIC.ENABLED = False
    return test.run(args, cfg)


if __name__ == '__main__':
    main()
