"""The federated round loop."""
