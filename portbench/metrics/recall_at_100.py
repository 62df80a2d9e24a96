"""Mean over every reply of the window of the share of its results that
are among the exact top 100 under the same filter (a result at the
100th place's exact distance, to the cell's distance tolerance, counts):
the reference's judgement of each distinct reply, weighted by how many
replies gave it."""


def read(run):
    return run.verdict.recall
