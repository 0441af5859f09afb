"""Core codec of the port: Bernoulli utilities, block plans, MRC, bit meter."""
