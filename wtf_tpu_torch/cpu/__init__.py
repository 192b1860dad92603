"""Interpreter core: uop encoding, host decoder, executors.

The TPU-native replacement for the reference's bochscpu emulator layer
(SURVEY.md §2.6): decode once on host, execute batched on device.
"""
