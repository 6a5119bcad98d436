"""Plain references the benchmark judges the program's outputs by. A
configuration's ``reference`` key names the module here that computes its
model; ``quant`` is the streamed chunks' quantizer. Nothing here imports
the program."""
