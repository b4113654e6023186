"""The paper's own image-classification model (Sec. 5): 784-128-64-10 MLP,
ReLU hidden activations, softmax output, cross-entropy loss.

The paper's model size d = 109,184 = 784*128 + 128*64 + 64*10 (weights
only); with biases d = 109,386, which over 4096 subcarriers is 27 slots.
The port's copy of ``repro/configs/paper_mlp.py``.
"""
LAYER_SIZES = (784, 128, 64, 10)
PAPER_MODEL_SIZE_D = 784 * 128 + 128 * 64 + 64 * 10
MODEL_SIZE_D = PAPER_MODEL_SIZE_D + 128 + 64 + 10
N_SUBCARRIERS = 4096
LOCAL_ITERS = 20        # Appendix H: 20 local Adam iterations per round
LOCAL_LR = 0.01
BATCH_SIZE = 100
RHO = 0.5
