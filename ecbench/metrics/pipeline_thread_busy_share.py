"""The busiest dispatch-pipeline thread's seconds in work spans over the
window's seconds, in %: how near one of the dispatcher, stager and
collector threads is to pacing the pipeline (`ecbench spans` names it)."""


def read(rec):
    th = rec["delta"].get("threads")
    if rec["entry"] != "write" or not th:
        return None
    work = [v for k, v in th.items() if k.endswith("/work_s")]
    return 100.0 * max(work) / rec["window_s"] if work else None
