"""The model substrate (port of ``repro.models``): layers, RWKV-6, assembly."""
