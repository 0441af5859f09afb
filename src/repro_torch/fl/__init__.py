"""Federated-learning stack of the port: nets, data, tasks, channels, engine,
registry and the federator entry point."""
