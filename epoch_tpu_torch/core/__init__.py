"""Simulation core of the port: grid, config, state, fields, particles."""
