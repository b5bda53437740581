"""The benchmark's plain reference (see trapeze.py); one module of equations
per configuration, named as the configuration."""
