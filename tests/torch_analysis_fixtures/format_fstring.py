"""Fixture for rule ``format`` on Python 3.12's f-string tokens.

``label`` holds a single-quoted key inside a double-quoted f-string, which
the format gate allows; ``PLAIN`` is a single-quoted f-string, which it
does not.
"""


def label(d):
    return f"{d['k']}"


PLAIN = f'plain'
