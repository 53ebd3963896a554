'''Nothing the benchmark runs loads JAX or the JAX package, and the reference loads nothing
of the program: each checked in a fresh interpreter by whole top-level module names (the
port's name, tcow_tpu_torch, begins with the JAX package's, tcow_tpu).'''

import json
import subprocess
import sys

from perfbench.core import cell as cell_lib

ROOT = str(cell_lib.ROOT)


def loaded_after(code: str, block=('jax', 'tcow_tpu')) -> set:
    '''The top-level names in sys.modules after running `code` in a fresh interpreter in
    which importing any name of `block` fails.'''
    prog = (f'import sys; sys.path.insert(0, {ROOT!r})\n'
            + ''.join(f'sys.modules[{b!r}] = None\n' for b in block)
            + code + '\n'
            'import json; print(json.dumps(sorted({m.split(".")[0] for m, v in '
            'list(sys.modules.items()) if v is not None})))')
    out = subprocess.run([sys.executable, '-c', prog], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def perfbench_modules():
    names = []
    for path in sorted(cell_lib.BENCH_DIR.rglob('*.py')):
        rel = path.relative_to(cell_lib.ROOT).with_suffix('')
        if 'tests' in rel.parts or 'metrics' in rel.parts:
            continue
        names.append('.'.join(rel.parts))
    return names


def test_no_module_of_the_benchmark_loads_jax_or_the_jax_package():
    code = ''.join(f'import {m}\n' for m in perfbench_modules())
    code += ('from perfbench.core import cell as c\n'
             'for m in json.load(open("BENCHMARK.json"))["per_layer"]:\n'
             '    c.load_reader(m["name"])\n').replace('json.load', '__import__("json").load')
    code += 'import tcow_tpu_torch.train.step, tcow_tpu_torch.evaluation.inference\n'
    loaded = loaded_after(code)
    assert not loaded & {'jax', 'jaxlib', 'flax', 'tcow_tpu'}
    assert 'tcow_tpu_torch' in loaded


def test_reference_loads_nothing_of_the_program():
    loaded = loaded_after('import perfbench.reference.seeker',
                          block=('jax', 'tcow_tpu', 'tcow_tpu_torch'))
    assert not loaded & {'jax', 'jaxlib', 'flax', 'tcow_tpu', 'tcow_tpu_torch'}


def test_run_refuses_without_a_card_or_without_the_program(tmp_path):
    '''Without CUDA the command exits non-zero and prints no result; so it does in a
    directory that holds only BENCHMARK.json and perfbench/.'''
    import shutil
    out = subprocess.run([sys.executable, 'perfbench/run.py', '--workload', 'train.divst',
                          '--seed', '2147483999', '--seconds', '1', '--trace', '0'],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and not out.stdout.strip()
    shutil.copy(cell_lib.ROOT / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    shutil.copytree(cell_lib.BENCH_DIR, tmp_path / 'perfbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = subprocess.run([sys.executable, 'perfbench/run.py', '--workload', 'train.divst',
                          '--seed', '5', '--seconds', '1', '--trace', '0'],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
