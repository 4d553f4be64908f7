"""``replan_share.step`` (%): the window's steps that replanned
(``StepReport.replanned``; respecs among them) over all its steps."""


def read(run):
    steps = [info for info in run.infos if "replanned" in info]
    if not steps:
        return None
    return 100.0 * sum(bool(i["replanned"]) for i in steps) / len(steps)
