"""Run the mark-I workflow alone on an existing helium workdir.

Separates the framework's own wall/RSS from the simulator's (the
simulate+index setup is the reference quick-start's untimed preamble;
its numpy arrays dominated the combined process's peak RSS).  Prints
one JSON line with stage walls and the workflow-only peak RSS.

Usage: python tools/helium_workflow_only.py WORKDIR [COVERAGE]
"""

import json
import os
import resource
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tools'))


def main():
    from sim_trio_bench import HELIUM, workflow_config
    workdir = sys.argv[1]
    coverage = float(sys.argv[2]) if len(sys.argv) > 2 else 30
    os.chdir(workdir)
    config = workflow_config(HELIUM['genome_size'], coverage, threads=1)
    from kevlar_tpu import workflow
    # backend start-up and first compiles fall inside the timed wall
    t0 = time.time()
    final = workflow.run_mark1(config)
    wall = round(time.time() - t0, 1)
    rss = round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
                1)
    stages = dict(getattr(workflow.run_mark1, 'last_stage_times', []))
    npass = 0
    import gzip
    with gzip.open(final, 'rt') as fh:
        for line in fh:
            if not line.startswith('#') and '\tPASS\t' in line:
                npass += 1
    print(json.dumps({'metric': 'helium_workflow_only', 'wall_s': wall,
                      'peak_rss_mb': rss, 'pass_calls': npass,
                      'stage_wall_s': stages}))


if __name__ == '__main__':
    main()
