"""The benchmark's plain references: the operators and the conjugate-gradient
iteration written straight from their definitions in PyTorch, without the
program. They import torch alone, take the seeded inputs the harness made
(grid sizes, right-hand sides, conductivities) and rebuild from them every
operator the program derived on its own (its CSR values, DIA tables, factors).
"""
