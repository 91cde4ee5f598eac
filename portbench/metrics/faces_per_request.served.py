"""Faces answered per request (boxes that passed the box rules, each
embedded), over the answered requests."""


def read(run):
    return run.work.get("faces_per_request")
