"""The plain reference the benchmark holds the program against.

Plain PyTorch, written from the textbook definitions (Adam; error
feedback around a bf16 round trip or a block-wise int8 quantiser).  It
imports nothing of ``repro_torch`` and takes nothing the program made:
it draws the seeded inputs again itself and reads the program's outputs
only to judge them.
"""
