"""The plain reference of the benchmark (`tracer`): plain PyTorch, no
import of the program, nothing taken from it."""
