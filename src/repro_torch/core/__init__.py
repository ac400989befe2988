"""Core of the port: BS-CSR encode, partitioning, precision model, index API."""
