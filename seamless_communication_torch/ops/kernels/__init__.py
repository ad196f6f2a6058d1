"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``launch_counts`` holds, for each kernel, how many times its wrapper launched
it on the card; a wrapper adds one where it launches and nowhere else, so a
run can show that a path went through the kernel.
"""

from typing import Dict

launch_counts: Dict[str, int] = {"decode_attention_int8": 0,
                                 "decode_attention_int4": 0,
                                 "decode_attention_indexed": 0,
                                 "fbank": 0,
                                 "flash_attention": 0,
                                 "flash_attention_bwd_dkv": 0,
                                 "flash_attention_bwd_dq": 0,
                                 "vocab_topk": 0,
                                 "vocab_topk_v2": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
