"""One module a job kind, ``<kind>.py``, named by a traffic file's ``job``.

Each defines ``run(counter, graph)``, the timed call; ``reference(oriented,
dtype)``, the plain reference's answer (``dtype=torch.float32``: the
precision control); ``in_generated_ids(answer, perm)``, an answer of a
relabelled copy (vertex ``v`` renamed ``perm[v]``) in the generated
graph's ids; ``compare(answers, ref)``, each number compared as
``{name: value}``; ``LIMITS``, each number's limit; and
``result_values(graph)``, the values the answer holds, for the bytes model.
"""
