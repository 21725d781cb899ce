"""The plain reference that decides ``correct``.

Float64 PageRank, personalized PageRank and the application of edge
deltas, in plain torch and numpy.  It imports nothing of the program and
takes only what the harness made: edge lists, seed sets and deltas.  The
same code computes the control (``precision="tf32"``): every product of
the transition matrix with a vector on TF32-rounded operands, accumulated
in float32, the step below the float32 that the configurations state.
"""
