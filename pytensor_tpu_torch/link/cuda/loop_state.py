"""The device words of a Poisson or binomial draw, as ``csrc/loops.cuh``
numbers them.

A draw is one cooperative launch in three phases: A (each element of the
monotone branch to its end, each rejection element to its first accept),
B (jax's dummy parameters' first accepts, where they can raise the pass
count N) and C (each rejection element's last accept before pass N,
searched down from N - 1); B and C run only where some element takes the
rejection branch.  ``STATE_WORDS`` int32 of scratch hold N, phase A's
record (the tiles grouped, and in the next word those with a rejection
element: the flag) and the grid barrier's count and generation.
"""

STATE_WORDS = 6
# the words that hold N and the flag (the tiles with a rejection element,
# nonzero where phases B and C run)
STATE_N, STATE_FLAG = 0, 3
