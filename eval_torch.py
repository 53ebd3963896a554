'''
Evaluation CLI of the PyTorch port: parses the test flags (tcow_tpu_torch/config.py, the
JAX package's eval flags) and runs tcow_tpu_torch.evaluation.test_driver.main on the GPU,
or on the CPU with --device cpu. eval/test.py stays the JAX package's.

Examples:
  python eval_torch.py --resume v1 --name v1_kc --data_path /path/to/kubric_containers/ \
      --num_queries 1
  python eval_torch.py --resume v1 --name rb1 --data_path demo/rollball.mp4 --num_queries 1
Then a representative subset:
  python -m tcow_tpu_torch.evaluation.pick_represent --testres_path 'logs/v1/test_*' \
      --represent_guide rep_lists/demo_rollball.txt --output_dir represent/
'''

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    from tcow_tpu_torch import config as config_lib
    from tcow_tpu_torch.evaluation import test_driver
    from tcow_tpu_torch.utils.logvis import MyLogger

    test_args = config_lib.test_args(argv)
    logger = MyLogger(test_args, context='test_' + test_args.name)
    try:
        return test_driver.main(test_args, logger)
    except Exception as e:
        logger.exception(e)
        logger.warning('Shutting down due to exception...')
        raise
    finally:
        logger.close()


if __name__ == '__main__':
    main()
