from cuahn_vio_torch.train.trainer import (  # noqa: F401
    Batch,
    OptaxAdamW,
    TrainConfig,
    draw_pairs,
    make_batch,
    make_loss_fn,
    make_optimizer,
    make_train_step,
    render_pairs,
    train,
)
