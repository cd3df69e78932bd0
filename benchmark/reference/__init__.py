"""The plain reference the benchmark holds the program to: numpy and plain
torch in float32 (TF32 off), importing nothing of the program. It takes
the benchmark's inputs (specs, TF-named weights, the generator's seed
state) and works out again everything the program derives from them.
"""
