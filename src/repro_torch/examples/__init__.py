"""Torch twins of the runnable examples (``examples/`` at the root of the
repo), on the card by default:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_llm_federated \
        [--d-model 256 --layers 8 --steps 300] [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.privacy_attack_demo \
        [--device cpu]

Each prints what its JAX twin prints, and its ``main(argv)`` returns the
run's headline numbers.
"""
