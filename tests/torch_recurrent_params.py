"""Parameters of the recurrent blocks (Mamba2's SSD, RecurrentGemma's
RG-LRU and their trunks) for the tests of ``repro_torch`` against the
reference: the leaves the reference initialises to zeros or ones, and a
redraw of them around their centres, so that their code paths carry
weight."""
import numpy as np

#: (centre, spread) of the leaves of the SSM and hybrid configs that the
#: reference sets to zeros or ones
REC_AROUND = {"ln1": (1.0, 0.1), "ln2": (1.0, 0.1), "norm_g": (1.0, 0.1),
              "A_log": (0.0, 0.5), "D": (1.0, 0.1), "dt_bias": (0.0, 0.5),
              "conv_b": (0.0, 0.1), "b_a": (0.0, 0.5), "b_i": (0.0, 0.5),
              "lam": (1.0, 0.5)}
#: the SSD block with dt in Mamba2's trained range: softplus(dt_bias - 4)
#: is ~0.02 a token and A = -exp(A_log) ~ -1, so a chunk's summed log
#: decay is ~-1 to -3 and the state carried across chunks holds weight
#: (around REC_AROUND's centres it is ~-100, and exp of it ~0)
SSD_TRAINED_AROUND = {**REC_AROUND, "A_log": (0.0, 0.1),
                      "dt_bias": (-4.0, 0.5)}


def redraw(tree, rng, around=REC_AROUND):
    """Every leaf of ``around`` in ``tree`` (dicts and lists, at any depth)
    redrawn in place around its centre, in the tree's order."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in list(items):
        if isinstance(v, (dict, list)):
            redraw(v, rng, around)
        elif k in around:
            centre, spread = around[k]
            tree[k] = (centre + spread * rng.standard_normal(v.shape)
                       ).astype(np.float32)
