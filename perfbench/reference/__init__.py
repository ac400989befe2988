"""Plain references the benchmark judges the program against.

torch and numpy only: no module here imports ``jax``, ``jaxlib``, ``repro``
or ``repro_torch``, and none takes anything the program made.
"""
