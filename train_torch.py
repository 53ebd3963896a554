'''
Training CLI of the PyTorch port: parses the train flags (tcow_tpu_torch/config.py, the
JAX package's train flags) and runs tcow_tpu_torch.train.driver.main on the GPU, or on
the CPU with --device cpu. train.py stays the JAX package's.

Example (the configuration of record):
  python train_torch.py --name v1 --data_path /path/to/kubric_random/ --batch_size 2 \
      --num_queries 3 --num_frames 30 --causal_attention 1
A synthetic Kubric-format dataset: python -m tcow_tpu_torch.data.synthetic --out DIR
'''

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    from tcow_tpu_torch import config as config_lib
    from tcow_tpu_torch.train import driver
    from tcow_tpu_torch.utils.logvis import MyLogger

    args = config_lib.train_args(argv)
    logger = MyLogger(args, context='train')
    logger.info(f'Args: {vars(args)}')
    try:
        driver.main(args, logger)
        logger.info('Finished train_torch.py')
    except Exception as e:
        logger.exception(e)
        raise
    finally:
        logger.close()


if __name__ == '__main__':
    main()
